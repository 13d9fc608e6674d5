"""index_s: stage 1, the SHIMMER index (build_shimmer_index), in seconds
a window assembly, from the program's `stage_wall` log records."""


def read(ctx):
    v = [r["walls"]["index"] for r in ctx["runs"] if "index" in r["walls"]]
    return sum(v) / len(v) if v else None
