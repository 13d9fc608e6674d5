"""polish_native_share: the share of the consensus workers' time spent in
the native window core (window_cns, which releases the GIL): the
windows' summed `native_s` over the consensus.windows seconds times its
`workers`, a window assembly."""

import progspans


def _share(recs):
    pools = progspans.named(recs, "consensus.windows")
    cap = sum((r.t1 - r.t0) * r.attrs["workers"] for r in pools)
    if cap <= 0:
        return None
    return sum(r.attrs.get("native_s", 0.0)
               for r in progspans.named(recs, "consensus.window")) / cap


def read(ctx):
    return progspans.mean(ctx, _share)
