"""polish_s: stage 4 in seconds a window assembly (the contig index, the
mapping and the consensus), from the program's `stage_wall` log records."""

PARTS = ("ctg_index", "mapping", "consensus")


def read(ctx):
    v = [sum(r["walls"][p] for p in PARTS) for r in ctx["runs"]
         if all(p in r["walls"] for p in PARTS)]
    return sum(v) / len(v) if v else None
