"""overlap_s: stage 2, the overlaps (build_overlaps), in seconds a
window assembly, from the program's `stage_wall` log records."""


def read(ctx):
    v = [r["walls"]["overlap"] for r in ctx["runs"] if "overlap" in r["walls"]]
    return sum(v) / len(v) if v else None
