"""layout_s: stage 3, the string graph, the layout and the draft contigs
(build_contigs), in seconds a window assembly, from the program's
`stage_wall` log records."""


def read(ctx):
    v = [r["walls"]["layout"] for r in ctx["runs"] if "layout" in r["walls"]]
    return sum(v) / len(v) if v else None
