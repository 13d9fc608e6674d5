"""index_host_s: stage 1's host seconds a window assembly (_index_of,
captures, slicing, fetches), the program's ops.index.STATS["host_s"]
summed, reset before each assembly."""


def read(ctx):
    v = [r["index_host_s"] for r in ctx["runs"]]
    return sum(v) / len(v) if v and any(v) else None
