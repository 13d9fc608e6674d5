"""index_save_s: stage 1's writes of the index files (and the level-0
index's), in seconds a window assembly: the program's index.save span."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("index.save", "index"))
