"""overlap_wait_share: the share of the host aligner threads' time in
stage 2's rounds spent polling for work: the rounds' summed `wait_s`
over their seconds times their `workers`, a window assembly (the host
backend; the device backend's rounds carry no wait_s)."""

import progspans


def _share(recs):
    rounds = [r for r in progspans.named(recs, "overlap.round")
              if "wait_s" in r.attrs]
    cap = sum((r.t1 - r.t0) * r.attrs["workers"] for r in rounds)
    if cap <= 0:
        return None
    return sum(r.attrs["wait_s"] for r in rounds) / cap


def read(ctx):
    return progspans.mean(ctx, _share)
