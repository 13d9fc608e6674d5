"""seqdb_s: stage 0, the seqdb build and its upload to the card
(build_db), in seconds a window assembly, from the program's
`stage_wall` log records."""


def read(ctx):
    v = [r["walls"]["seqdb"] for r in ctx["runs"] if "seqdb" in r["walls"]]
    return sum(v) / len(v) if v else None
