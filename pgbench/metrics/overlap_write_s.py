"""overlap_write_s: stage 2's write of preads.ovl, in seconds a window
assembly: the program's overlap.write span."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("overlap.write", "overlap"))
