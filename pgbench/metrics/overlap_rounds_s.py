"""overlap_rounds_s: stage 2's collect/align rounds, in seconds a window
assembly: the program's overlap.round spans summed."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("overlap.round", "overlap"))
