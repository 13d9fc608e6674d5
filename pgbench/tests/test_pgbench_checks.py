"""The check that decides `correct`, driven through a whole run at a size
the CPU holds: sound runs pass; the control (the reference in a lower
precision in the program's place) and each fault planted in the timed
path fail.  The harness's look for a card is skipped here; the program
runs its plain kernels on the CPU.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PGB = os.path.dirname(HERE)
ROOT = os.path.dirname(PGB)
sys.path.insert(0, PGB)
sys.path.insert(1, ROOT)

import faults  # noqa: E402
import gen  # noqa: E402
import run  # noqa: E402

SEED = 2**31 + 77


@pytest.fixture
def tiny(tmp_path):
    """A folder of cells/, configs/ and metrics/ with one small cell of
    ecoli_k12.asm_cns's shape, and its BENCHMARK.json."""
    root = tmp_path / "pgbench"
    (root / "cells").mkdir(parents=True)
    (root / "configs").mkdir()
    shutil.copytree(os.path.join(PGB, "metrics"), root / "metrics")
    cfg = json.load(open(os.path.join(PGB, "configs", "ecoli_k12.json")))
    cfg["name"] = "tiny"
    cfg["genome"].update(genome_length=120000, wrap=8000)
    cfg["reads"].update(files=2, reads_per_file=110, read_len=5000,
                        len_sd=500)
    cfg["host"] = {"workers": 2, "n_chunks": 2}
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    cell = json.load(open(os.path.join(PGB, "cells",
                                       "ecoli_k12.asm_cns.json")))
    cell.update(config="tiny", traffic="cns", warm_span=20000)
    # reads of 5 kb find fewer of their neighbours than reads of 15 kb:
    # sound runs read 5-14 on six seeds, stage 2 on half its batch 52
    cell["limits"]["ovl_miss"] = 30.0
    (root / "cells" / "tiny.cns.json").write_text(json.dumps(cell))
    cell.update(traffic="draft", with_consensus=False)
    del cell["limits"]["cns_err"]
    (root / "cells" / "tiny.draft.json").write_text(json.dumps(cell))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root, capsys, trace=0, cell="tiny.cns"):
    args = run.parse(["--workload", cell, "--seed", str(SEED),
                      "--seconds", "1", "--trace", str(trace)])
    rc = run.run(args, device="cpu", require_chip=False, root=str(root),
                 bench_path=str(root.parent / "BENCHMARK.json"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(tiny, capsys):
    line = run_tiny(tiny, capsys)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert {"asm_rate", "setup_s", "peak_rss_GiB", "peak_device_GiB"} <= \
        set(line["metrics"])
    line = run_tiny(tiny, capsys, trace=1)
    assert line["correct"] and "index_s" in line["metrics"]
    assert "index_roofline" not in line["metrics"]   # no device: no share


@pytest.mark.parametrize("control,number", [("index", "index_diff"),
                                            ("polish", "cns_err")])
def test_control_is_not_correct(tiny, control, number, tmp_path):
    cell, cfg = run.load_cell("tiny.cns", str(tiny))
    prog = run.Program(cell, cfg, "cpu")
    g = gen.genome(SEED, cfg)
    manifest, _, _, _, layout = gen.write_reads(
        SEED, cfg, g, str(tmp_path / "r"), cell["warm_span"])
    out = str(tmp_path / "asm")
    prog.assemble(manifest, out, False)
    reads = list(gen.manifest_reads(manifest))
    sound = run.check_outputs(out, cell, cfg, prog.settings, reads, g, layout,
                              SEED)
    ctl = run.check_outputs(out, cell, cfg, prog.settings, reads, g, layout,
                            SEED, control=control)
    assert sound[number] <= cell["limits"][number] < ctl[number]


@pytest.mark.parametrize("fault,cell,number", [
    ("stage2_none", "tiny.draft", "genome_miss"),   # stage 4 needs contigs
    ("stage1_half", "tiny.cns", "index_diff"),
    ("stage2_half", "tiny.cns", "ovl_miss"),
    ("stage2_altered", "tiny.cns", "ovl_gap")])
def test_fault_is_not_correct(tiny, capsys, fault, cell, number):
    with faults.planted(fault):
        line = run_tiny(tiny, capsys, cell=cell)
    assert not line["correct"], line["checks"]
    c = line["checks"][number]
    assert c["value"] > c["limit"]


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(PGB, "run.py"), "--workload",
         "ecoli_k12.asm_cns", "--seed", str(SEED), "--seconds", "1",
         "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, TMPDIR=str(tmp_path)), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["index_roofline"]["value"] <= 100
