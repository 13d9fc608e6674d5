"""The per-layer metrics that read the program's own spans, through whole
runs with --trace 1 at a size the CPU holds: the tiny cell of
ecoli_k12.asm_cns's shape (host aligner, stages 0-4), and its draft with
the device aligner and the device pair map (their plain versions on the
CPU).

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

STAGE2 = ("overlap_pairs_s", "overlap_rounds_s", "overlap_final_s",
          "overlap_write_s")
HOST = STAGE2 + ("overlap_alignments", "overlap_wait_share",
                 "polish_windows_s", "polish_native_share", "index_of_s",
                 "index_save_s", "layout_sg_s")


def _values(line):
    return {k: v["value"] for k, v in line["metrics"].items()}


def _stage2_covered(m):
    share = sum(m[k] for k in STAGE2) / m["overlap_s"]
    assert 0.90 <= share <= 1.005, (share, m)


def test_span_metrics_host_cell(tiny, capsys):
    line = run_tiny(tiny, capsys, trace=1)
    assert line["correct"], line["checks"]
    m = _values(line)
    assert set(HOST) <= set(m), sorted(set(HOST) - set(m))
    assert "align_device_lanes" not in m     # the host aligner has no lanes
    _stage2_covered(m)
    assert 0 <= m["overlap_wait_share"] <= 1
    assert 0 <= m["polish_native_share"] <= 1
    assert m["overlap_alignments"] > 0
    assert m["polish_windows_s"] < m["polish_s"]
    assert m["index_of_s"] + m["index_save_s"] < m["index_s"]
    assert m["layout_sg_s"] < m["layout_s"]


def test_span_metrics_device_cell(tiny, capsys):
    cell = json.loads((tiny / "cells" / "tiny.draft.json").read_text())
    cell.update(traffic="dev", device_aligner=True, device_pairs=True)
    (tiny / "cells" / "tiny.dev.json").write_text(json.dumps(cell))
    line = run_tiny(tiny, capsys, trace=1, cell="tiny.dev")
    assert line["correct"], line["checks"]
    m = _values(line)
    assert m["align_device_lanes"] > 0
    _stage2_covered(m)
    # the device backend's rounds carry no aligner threads' waits, and
    # a draft has no consensus
    for name in ("overlap_wait_share", "polish_windows_s",
                 "polish_native_share"):
        assert name not in m


@pytest.mark.parametrize("name", HOST + ("align_device_lanes",))
def test_reader_finds_nothing(name, monkeypatch):
    """Where the ring holds no `seqdb` span of the first window assembly
    (it wrapped), and where the program has no recorder (as a parent
    without one), the reader returns None: the metric leaves the line."""
    import peregrine_tpu_torch
    import run
    from peregrine_tpu_torch import trace  # noqa: F401
    read = run.plugins.load(run.HERE, "metrics", name, "read")
    ctx = {"runs": [{"spans": [("seqdb", -2.0, -1.0)], "walls": {}}]}
    assert read(ctx) is None
    monkeypatch.delattr(peregrine_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "peregrine_tpu_torch.trace", None)
    assert read(ctx) is None
