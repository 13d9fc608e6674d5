"""overlap_final_inline: the alignments stage 2's exact final pass makes
inline, on one thread, a window assembly: the `inline` attr of the
program's overlap.final span (the misses the harvest rounds left)."""

import progspans


def _count(recs):
    final = progspans.named(recs, "overlap.final", "overlap")
    if not final:
        return None
    return sum(r.attrs.get("inline", 0) for r in final)


def read(ctx):
    return progspans.mean(ctx, _count)
