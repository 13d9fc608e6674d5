"""The per-layer metrics that read stage 2's rejecter counters:
overlap_final_inline (the `inline` attr of the overlap.final span) and
overlap_rejecter_share (Σ round `rejecters` / Σ round `misses`), on
whole CPU runs with --trace 1 and on made-up span records.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_pgbench_checks import run_tiny, tiny  # noqa: E402,F401

NAMES = ("overlap_final_inline", "overlap_rejecter_share")


def _values(line):
    return {k: v["value"] for k, v in line["metrics"].items()}


def test_rejecter_metrics_host_cell(tiny, capsys):
    line = run_tiny(tiny, capsys, trace=1)
    assert line["correct"], line["checks"]
    m = _values(line)
    assert set(NAMES) <= set(m), sorted(set(NAMES) - set(m))
    assert 0 <= m["overlap_final_inline"] <= m["overlap_alignments"]
    assert 0 <= m["overlap_rejecter_share"] <= 1


def test_rejecter_metrics_device_cell(tiny, capsys):
    cell = json.loads((tiny / "cells" / "tiny.draft.json").read_text())
    cell.update(traffic="dev", device_aligner=True, device_pairs=True)
    (tiny / "cells" / "tiny.dev.json").write_text(json.dumps(cell))
    line = run_tiny(tiny, capsys, trace=1, cell="tiny.dev")
    assert line["correct"], line["checks"]
    m = _values(line)
    assert m["overlap_final_inline"] >= 0
    assert 0 <= m["overlap_rejecter_share"] <= 1


@pytest.mark.parametrize("name", NAMES)
def test_rejecter_reader_finds_nothing(name, monkeypatch):
    """Where the ring holds no `seqdb` span of the first window assembly,
    and where the program has no recorder, the reader returns None."""
    import peregrine_tpu_torch
    import run
    from peregrine_tpu_torch import trace  # noqa: F401
    read = run.plugins.load(run.HERE, "metrics", name, "read")
    ctx = {"runs": [{"spans": [("seqdb", -2.0, -1.0)], "walls": {}}]}
    assert read(ctx) is None
    monkeypatch.delattr(peregrine_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "peregrine_tpu_torch.trace", None)
    assert read(ctx) is None


def _span(name, t0, t1, **attrs):
    from peregrine_tpu_torch import trace
    rec = trace.Span(name, None, 1, attrs)
    rec.t0, rec.t1 = t0, t1
    return rec


def _two_assemblies(rejecters=True):
    """Made-up records of two window assemblies' stage 2, and their
    ctx: rounds of 1,000 + 300 and 800 misses, 0 + 120 and 80 of them
    rejecters; final passes of 500 and 100 inline misses."""
    recs, runs = [], []
    for t, rounds, inline in ((0.0, [(1000, 0), (300, 120)], 500),
                              (20.0, [(800, 80)], 100)):
        recs += [_span("seqdb", t, t + 1), _span("overlap", t + 1, t + 9)]
        for i, (miss, rej) in enumerate(rounds):
            attrs = dict(round=i + 1, misses=miss, aligned=miss)
            if rejecters:
                attrs["rejecters"] = rej
            recs.append(_span("overlap.round", t + 2 + i, t + 3 + i, **attrs))
        recs.append(_span("overlap.final", t + 6, t + 8, inline=inline))
        runs.append({"spans": [("seqdb", t, t + 1), ("layout", t + 9, t + 10)],
                     "walls": {}})
    return recs, {"runs": runs}


def test_rejecter_readers_on_made_up_spans(monkeypatch):
    """overlap_final_inline is the final pass's `inline` a window
    assembly; overlap_rejecter_share is Σ round `rejecters` over Σ round
    `misses`, each the mean over the window's assemblies, and nothing
    where the rounds carry no `rejecters` (a parent without the
    counter)."""
    import run
    from peregrine_tpu_torch import trace
    recs, ctx = _two_assemblies()
    monkeypatch.setattr(trace, "records", lambda: recs)
    inline, share = (run.plugins.load(run.HERE, "metrics", m, "read") for m
                     in ("overlap_final_inline", "overlap_rejecter_share"))
    assert inline(ctx) == 300
    assert share(ctx) == pytest.approx((120 / 1300 + 80 / 800) / 2)
    recs[:], _ = _two_assemblies(rejecters=False)
    assert inline(ctx) == 300
    assert share(ctx) is None
