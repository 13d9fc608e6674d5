"""overlap_pairs_s: stage 2's work before its first round, in seconds a
window assembly: the program's spans overlap.pairs (the pair map),
overlap.stream (the bucket stream) and overlap.upload (the device
backends' seqdb upload) inside its `overlap` span."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds(
        ("overlap.pairs", "overlap.stream", "overlap.upload"), "overlap"))
