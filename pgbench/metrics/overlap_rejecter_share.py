"""overlap_rejecter_share: the share of stage 2's harvested misses whose
rid pair already had a cached alignment failing the accept test in the
same collect pass, a window assembly: Σ `rejecters` / Σ `misses` over
the program's overlap.round spans.  A program whose rounds carry no
`rejecters` attr gives nothing."""

import progspans


def _share(recs):
    rounds = [r for r in progspans.named(recs, "overlap.round")
              if "rejecters" in r.attrs]
    misses = sum(r.attrs.get("misses", 0) for r in rounds)
    if not misses:
        return None
    return sum(r.attrs["rejecters"] for r in rounds) / misses


def read(ctx):
    return progspans.mean(ctx, _share)
