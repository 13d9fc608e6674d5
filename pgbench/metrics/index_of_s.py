"""index_of_s: stage 1's _index_of (the per-read records concatenated
and counted into the index), in seconds a window assembly: the program's
index.index_of span inside its `index` span (stage 4's contig index
left out)."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("index.index_of", "index"))
