"""overlap_alignments: stage 2's alignments a window assembly, counted by
the program: its rounds' `aligned` and its final pass's `inline`."""

import progspans


def _count(recs):
    rounds = progspans.named(recs, "overlap.round")
    final = progspans.named(recs, "overlap.final")
    if not rounds and not final:
        return None
    return (sum(r.attrs.get("aligned", 0) for r in rounds)
            + sum(r.attrs.get("inline", 0) for r in final))


def read(ctx):
    return progspans.mean(ctx, _count)
