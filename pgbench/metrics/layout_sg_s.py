"""layout_sg_s: stage 3's string graph (preads.ovl read and
generate_string_graph), in seconds a window assembly: the program's
layout.string_graph span."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("layout.string_graph",
                                                 "layout"))
