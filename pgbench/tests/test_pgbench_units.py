"""CPU tests of the benchmark's own parts: generator, files, arithmetic,
the plain reference, cell discovery and what the harness imports.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PGB = os.path.dirname(HERE)
ROOT = os.path.dirname(PGB)
sys.path.insert(0, PGB)

import devtrace  # noqa: E402
import gen  # noqa: E402
import judge  # noqa: E402
import refindex  # noqa: E402
import run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BIG_SEED = 2**31 + 12345

TINY = {
    "name": "tiny", "source": "test", "genome": {
        "model": "random", "genome_length": 60000, "wrap": 5000},
    "reads": {"files": 2, "reads_per_file": 40, "read_len": 3000,
              "len_sd": 300, "error": 0.01},
    "settings": {"k": 16, "w": 80, "r": 6, "levels": 2, "best_n_ovlp": 4},
    "host": {"workers": 2, "n_chunks": 2}}


def test_generator_frozen_digest(tmp_path):
    g = gen.genome(BIG_SEED, TINY)
    manifest, warm, n, bases, layout = gen.write_reads(
        BIG_SEED, TINY, g, str(tmp_path), 10000)
    h = hashlib.sha256(g.seqs[0].tobytes())
    for line in open(manifest):
        h.update(open(line.strip(), "rb").read())
    assert (n, bases) == (80, 238038) and layout.shape == (80, 4)
    assert h.hexdigest()[:16] == "67e30d8bf92051e1"
    assert len(g.seqs) == 1 and not layout[:, 3].any()
    # the same seed gives the same reads; another seed other reads
    g2 = gen.genome(BIG_SEED, TINY)
    m2, *_ = gen.write_reads(BIG_SEED, TINY, g2, str(tmp_path / "b"), 10000)
    assert (g2.seqs[0] == g.seqs[0]).all()
    assert [open(x).read() for x in open(m2).read().split()] == [
        open(x).read() for x in open(manifest).read().split()]
    g3 = gen.genome(BIG_SEED + 1, TINY)
    assert not (g3.seqs[0] == g.seqs[0]).all()


def test_layout_seed_fixes_the_sizes(tmp_path):
    cfg = json.loads(json.dumps(TINY))
    cfg["reads"]["layout_seed"] = 1
    got = []
    for seed in (BIG_SEED, BIG_SEED + 1):
        rng = gen.rng_for(seed, 2, 0)
        src = gen.read_source(gen.genome(seed, cfg).seqs[0], cfg)
        _, lens, starts, strands, _, _ = gen.simulate_seqs(
            rng, [src], 40, cfg["reads"], gen.rng_for(1, 2, 0))
        got.append((sorted(zip(starts.tolist(), strands.tolist())),
                    starts.tolist()))
    assert got[0][0] == got[1][0] and got[0][1] != got[1][1]
    spec = json.load(open(os.path.join(PGB, "configs", "chm13_r3.json")))
    spec = dict(spec["genome"], genome_length=300000, segdup_lengths=[20000])
    ev = [[], []]
    for i, seed in enumerate((BIG_SEED, BIG_SEED + 1)):
        gen.repeat_genome(gen.rng_for(seed, 1), spec, ev[i],
                          layout=gen.rng_for(1, 1))
    assert [e[0] for e in ev[0]] == [e[0] for e in ev[1]]
    # the places agree but for the indels of the copies before them
    assert all(abs(a[1] - b[1]) < 300 for a, b in zip(ev[0], ev[1]))


def test_generator_error_rate():
    rng = gen.rng_for(5, 9)
    src = gen.random_genome(rng, 100000)
    seq, lens, starts, strands, true_lens, _ = gen.simulate_seqs(
        rng, [src], 40, {"read_len": 2000, "len_sd": 100, "error": 0.01})
    offs = np.r_[0, np.cumsum(lens)]
    qs = [seq[offs[i]:offs[i + 1]] for i in range(40)]
    ts = []
    for i in range(40):
        t = src[max(0, starts[i] - 48):starts[i] + int(true_lens[i]) + 48]
        ts.append(gen.revcomp(t) if strands[i] else t)
    err = judge.band_dp(qs, ts, 48, True).sum() / lens.sum()
    assert 0.006 < err < 0.012


def test_files_follow_the_contract():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    assert set(run.list_cells()) == {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and len(w["why"]) <= 200
        cell, cfg = run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(PGB, "metrics", m["name"] + ".py"))


def _runs(*walls, gap=0.0):
    runs, t = [], 100.0
    for w in walls:
        runs.append({"spans": [("seqdb", t, t + w / 2), ("index", t + w / 2,
                                                         t + w)]})
        t += w + gap
    return runs


def test_window_runs_past_its_seconds():
    clock = iter([0.0, 3.0, 6.0, 9.0, 12.5, 99.0])
    got = run.drive(lambda i: i, 10.0, clock=lambda: next(clock))
    # assemblies end at 3, 6, 9 and 12.5: the one running at 10 finishes
    assert got == [0, 1, 2, 3]
    runs = _runs(3.0, 3.0, 3.0, 3.5)
    assert run.window_s(runs) == pytest.approx(12.5)
    assert run.asm_rate(10_000_000, runs) == pytest.approx(40 / 12.5)
    # the harness's work between assemblies is not the window's time
    runs = _runs(3.0, 3.0, 3.0, 3.5, gap=0.25)
    assert run.window_s(runs) == pytest.approx(12.5)


def test_true_pairs_hand_case(tmp_path):
    # reads as (start, length, strand) on a circular genome of 100,000:
    # read 2 lies inside read 1, read 5 is read 0 a turn on (the same
    # stretch, so inside it), and read 4 crosses the origin to meet read 0
    layout = np.array([[0, 20000, 0], [12000, 20000, 1], [14000, 9000, 0],
                       [25000, 20000, 0], [88000, 20000, 1],
                       [100000, 20000, 0]], np.int64)
    key = lambda a, b: min(a, b) << 32 | max(a, b)  # noqa: E731
    got = judge.true_pairs(layout, 100000, True, min_ovl=5000).tolist()
    assert got == sorted([key(0, 1), key(1, 3), key(4, 0)])
    # read 3 is 7,000 bases on from read 1: too little overlap at 8,000
    got = judge.true_pairs(layout[:4], 100000, False, min_ovl=8000).tolist()
    assert got == [key(0, 1)]
    d = tmp_path / "2-ovlp"
    d.mkdir()
    (d / "preads.ovl").write_text(
        "000000001 000000000 -8000 99.0 0 0 8000 20000 0 12000 20000 20000 "
        "overlap\n-\n")
    assert judge.ovl_miss(str(tmp_path), np.array(got)) == 0.0
    assert judge.ovl_miss(str(tmp_path), np.array(
        [key(0, 1), key(1, 3)])) == 50.0


def test_busy_and_idle_arithmetic():
    dev = [(0.0, 10.0, "a", "kernel"), (5.0, 20.0, "b", "kernel"),
           (30.0, 40.0, "a", "gpu_memcpy"), (95.0, 120.0, "c", "kernel")]
    spans = [(0.0, 50.0, "index"), (50.0, 100.0, "overlap")]
    assert devtrace.busy(dev, 0.0, 100.0) == pytest.approx(35.0)
    gaps = devtrace.idle_gaps(dev, spans, 0.0, 100.0, n=2)
    assert gaps == [["overlap", 55e-6], ["index", 10e-6]]
    assert devtrace.top_ops(dev, 0.0, 100.0, n=1) == [["a", 20e-6]]
    assert len(devtrace.within_spans(dev, spans, "index")) == 2


def test_reference_hand_case():
    # k=1: A, T hash to 3 and C, G to 2 (the mix masked to 2 bits); G and
    # T are on the reverse strand.  w=1 keeps every base; one level of
    # r=2 keeps C, then G (its slot 0 beats C's slot 1), then G again.
    s = [np.frombuffer(b"ACGT", np.uint8)]
    out = refindex.build(s, 1, 1, 2, 1, True)
    x, y, mer, cnt = out["L"]
    assert x.tolist() == [2 << 8 | 1] * 2 and y.tolist() == [1 << 1, 2 << 1 | 1]
    assert mer.tolist() == [2] and cnt.tolist() == [2]
    assert out["L0"][1].tolist() == [0, 2, 5, 7]
    # w=2: both tied minima of the window (C, G) are kept
    assert refindex.build(s, 2, 1, 2, 0, False)["L"][1].tolist() == [2, 5]


def test_band_dp_is_an_edit_distance():
    def ed(a, b):
        prev = np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            cur = np.empty_like(prev)
            cur[0] = i
            for j in range(1, len(b) + 1):
                cur[j] = min(prev[j - 1] + (a[i - 1] != b[j - 1]),
                             prev[j] + 1, cur[j - 1] + 1)
            prev = cur
        return prev[-1]
    rng = gen.rng_for(1, 1)
    qs = [gen.random_genome(rng, int(n)) for n in rng.integers(80, 160, 6)]
    ts = [gen.mutate_many(rng, q, np.array([len(q)]), 0.05)[0] for q in qs]
    assert judge.band_dp(qs, ts, 16, False).tolist() == \
        [int(ed(a, b)) for a, b in zip(qs, ts)]


def test_a_dropped_cell_file_is_listed(tmp_path):
    cells = tmp_path / "cells"
    cells.mkdir()
    for f in os.listdir(os.path.join(PGB, "cells")):
        (cells / f).write_bytes(open(os.path.join(PGB, "cells", f), "rb").read())
    (cells / "ecoli_k12.new_mix.json").write_text(json.dumps(
        {"config": "ecoli_k12", "traffic": "new_mix", "chips": 1}))
    assert "ecoli_k12.new_mix" in run.list_cells(str(cells))
    assert set(run.list_cells(str(cells))) - set(run.list_cells()) == \
        {"ecoli_k12.new_mix"}


IMPORTS = r"""
import sys
sys.path.insert(0, {pgb!r})
{body}
bad = sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "peregrine_tpu"}})
port = sorted(m for m in sys.modules if m.split(".")[0] == "peregrine_tpu_torch")
print(len(bad), len(port))
"""
# run.Program's imports: what the harness loads to drive the program
DRIVE = ("import run, torch\n"
         "from peregrine_tpu_torch.config import AsmConfig\n"
         "from peregrine_tpu_torch.ops import index\n"
         "from peregrine_tpu_torch.pipeline.run import Assembly")


@pytest.mark.parametrize("mod", ["drive", "run", "calibrate", "refindex",
                                 "judge", "gen", "devtrace"])
def test_imports(mod):
    body = DRIVE if mod == "drive" else f"import {mod}"
    out = subprocess.run(
        [sys.executable, "-c", IMPORTS.format(pgb=PGB, body=body)],
        capture_output=True, text=True, cwd=ROOT, check=True).stdout.split()
    assert out[0] == "0"            # no jax, jaxlib, flax or peregrine_tpu
    if mod != "drive":
        assert out[1] == "0"        # the harness's own modules, the reference
        #                             among them, take nothing of the program
