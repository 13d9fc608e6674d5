"""overlap_final_s: stage 2's exact final pass (the replay that aligns
its remaining misses inline), in seconds a window assembly: the
program's overlap.final span."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("overlap.final", "overlap"))
