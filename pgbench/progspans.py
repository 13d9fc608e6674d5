"""The program's own spans of the window's assemblies, for the readers of
`program_span` and `program_counter` metrics.

The program (peregrine_tpu_torch.trace) keeps its spans in a bounded ring
in memory, each with its name, its start and end on time.perf_counter()
and its attrs (counts).  The harness's spans in ctx["runs"] are on the
same clock in the same process, so a window assembly's records are those
whose interval lies inside that assembly's.  Where the program has no
such recorder, or its ring has dropped the first window assembly's
`seqdb` span, the readers find nothing and return None.
"""

from __future__ import annotations

import bisect


def by_assembly(ctx):
    """The program's records of each window assembly, in the order of
    ctx["runs"], or None."""
    try:
        from peregrine_tpu_torch import trace
    except ImportError:
        return None
    recs = trace.records()
    wins = [(r["spans"][0][1], r["spans"][-1][2]) for r in ctx["runs"]]
    a0, b0 = wins[0]
    if not any(r.name == "seqdb" and a0 <= r.t0 and r.t1 <= b0
               for r in recs):
        return None
    starts = [a for a, _ in wins]
    out = [[] for _ in wins]
    for r in recs:
        i = bisect.bisect_right(starts, r.t0) - 1
        if i >= 0 and r.t1 <= wins[i][1]:
            out[i].append(r)
    return out


def mean(ctx, fn):
    """The mean over window assemblies of fn(that assembly's records),
    over those for which fn returns a number; None where none does."""
    runs = by_assembly(ctx)
    if runs is None:
        return None
    v = [x for x in map(fn, runs) if x is not None]
    return sum(v) / len(v) if v else None


def named(recs, names, within: str | None = None) -> list:
    """The records whose name is one of `names`, and where `within` is
    given, only those inside a span of that name (a stage's, say)."""
    if isinstance(names, str):
        names = (names,)
    out = [r for r in recs if r.name in names]
    if within is not None:
        outer = [(r.t0, r.t1) for r in recs if r.name == within]
        out = [r for r in out if any(a <= r.t0 and r.t1 <= b
                                     for a, b in outer)]
    return out


def seconds(names, within: str):
    """fn for mean(): the summed seconds of the `names` spans inside the
    `within` span, None where the assembly has no `within` span."""
    def fn(recs):
        if not named(recs, within):
            return None
        return sum(r.t1 - r.t0 for r in named(recs, names, within))
    return fn
