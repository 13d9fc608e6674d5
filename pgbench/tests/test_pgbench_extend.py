"""A deployment that the harness has no words for, taken through new files
only: a genome model of two haplotypes (genomes/<model>.py), a cell that
gives the program options (`assembly`, `asm_config`) and a number of the
check of its own (checks/<name>.py), all under a root of the tests' own.
A name with no file or field fails as the cell is loaded, before any
reads are written.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PGB = os.path.dirname(HERE)
ROOT = os.path.dirname(PGB)
sys.path.insert(0, PGB)
sys.path.insert(1, ROOT)

import gen  # noqa: E402
import run  # noqa: E402

SEED = 2**31 + 99
ALT = ("3-asm/a_ctg.fa", "4-cns-alt/a_ctg_cns.fa")

GENOME = '''"""Two haplotypes of one linear chromosome: the second differs from the
first by SNVs at `snv_rate` a base and one insertion of `insertion` bases
at a place drawn from the layout."""

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def genome(rng, spec, layout):
    lay = rng if layout is None else layout
    n = int(spec["genome_length"])
    code = rng.integers(0, 4, n)
    snv = np.sort(lay.choice(n, int(n * spec["snv_rate"]), replace=False))
    other = code.copy()
    other[snv] = (other[snv] + rng.integers(1, 4, len(snv))) % 4
    at = int(lay.integers(n // 3, 2 * n // 3))
    ins = ACGT[rng.integers(0, 4, int(spec["insertion"]))]
    hap2 = np.concatenate([ACGT[other[:at]], ins, ACGT[other[at:]]])
    return ([("hap1", ACGT[code], False), ("hap2", hap2, False)],
            {"insertion": [at, len(ins)], "snvs": snv.tolist()})
'''

CHECK = '''"""insertion_miss: % of the heterozygous insertion's 16-mers that no
draft or alternate contig holds, on either strand."""

import os

import gen


def _kmers(s):
    return {bytes(s[i:i + 16]) for i in range(len(s) - 15)}


def check(ctx):
    at, n = ctx["genome"].truth["insertion"]
    want = _kmers(ctx["genome"].seqs[1][at:at + n])
    have = set()
    for f in ("p_ctg.fa", "a_ctg.fa"):
        p = os.path.join(ctx["outdir"], "3-asm", f)
        if os.path.exists(p):
            for _, s in gen.read_fasta(p):
                have |= _kmers(s) | _kmers(gen.revcomp(s))
    return 100.0 * len(want - have) / len(want)
'''

CONFIG = {
    "name": "diploid", "source": "test",
    "genome": {"model": "two_haplotypes", "genome_length": 60000,
               "snv_rate": 0.001, "insertion": 5000, "layout_seed": 1},
    "reads": {"files": 2, "reads_per_file": 130, "read_len": 5000,
              "len_sd": 500, "error": 0.01, "layout_seed": 1},
    "settings": {"k": 16, "w": 80, "r": 6, "levels": 2, "best_n_ovlp": 4},
    "host": {"workers": 2, "n_chunks": 2}}

# a_ctg.fa is ~34 kb here, so the alternate contigs' polish runs only
# with alt_cns_min_size cut from its 500 kB
CELL = {
    "config": "diploid", "traffic": "alt", "chips": 1,
    "with_consensus": True, "device_aligner": False, "device_pairs": False,
    "with_l0": False, "warm_span": 20000,
    "asm_config": {"alt_cns_min_size": 1000},
    "assembly": {"with_alt": True},
    "limits": {"runs_differ": 0, "index_diff": 0, "ovl_gap": 2.0,
               "ovl_miss": 30.0, "insertion_miss": 50.0}}


# a check file that loads a module the run may not hold
LOADS_FLAX = '''import sys
import types


def check(ctx):
    sys.modules["flax"] = types.ModuleType("flax")
    return 0.0
'''


def write_root(base, cfg=CONFIG, cell=CELL, extra_metric=False):
    """A harness root of the tests' own and its BENCHMARK.json."""
    root = base / "pgbench"
    for d in ("cells", "configs", "genomes", "checks"):
        (root / d).mkdir(parents=True)
    shutil.copytree(os.path.join(PGB, "metrics"), root / "metrics")
    (root / "genomes" / "two_haplotypes.py").write_text(GENOME)
    (root / "checks" / "insertion_miss.py").write_text(CHECK)
    (root / "checks" / "loads_flax.py").write_text(LOADS_FLAX)
    (root / "configs" / "diploid.json").write_text(json.dumps(cfg))
    (root / "cells" / "diploid.alt.json").write_text(json.dumps(cell))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    if extra_metric:
        bench["per_layer"].append(dict(bench["per_layer"][0],
                                       name="no_such_metric"))
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root, capsys):
    args = run.parse(["--workload", "diploid.alt", "--seed", str(SEED),
                      "--seconds", "1"])
    rc = run.run(args, device="cpu", require_chip=False, root=str(root),
                 bench_path=str(root.parent / "BENCHMARK.json"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_reads_of_several_sequences(tmp_path):
    """Error-free reads are their sequence's bases: no read crosses from
    one haplotype to the other; the layout seed fixes the division."""
    root = write_root(tmp_path)
    cfg = json.loads(json.dumps(CONFIG))
    cfg["reads"]["error"] = 0.0
    rows = []
    for seed in (SEED, SEED + 1):
        g = gen.genome(seed, cfg, root=str(root))
        assert g.names == ["hap1", "hap2"] and g.circular == [False, False]
        manifest, _, n, _, layout = gen.write_reads(
            seed, cfg, g, str(tmp_path / str(seed)), 20000)
        for r, (start, ln, strand, s) in zip(gen.manifest_reads(manifest),
                                             layout.tolist()):
            assert 0 <= start and start + ln <= len(g.seqs[s])
            want = g.seqs[s][start:start + ln]
            assert (r == (gen.revcomp(want) if strand else want)).all()
        share = np.bincount(layout[:, 3], minlength=2) / n
        assert abs(share[1] - 65 / 125) < 0.1    # by length, 60 + 65 kb
        rows.append(sorted(map(tuple, layout.tolist())))
    assert rows[0] == rows[1]


def test_digest_takes_alt_contigs_where_written(tmp_path, monkeypatch):
    for rel in ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(">c\nACGT\n")
    now = run.digest(str(tmp_path))
    with monkeypatch.context() as m:   # the outputs digested before
        m.setattr(run, "OUTPUTS", run.OUTPUTS[:4])
        assert run.digest(str(tmp_path)) == now
    for rel in ALT:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(">a\nACGT\n")
        assert run.digest(str(tmp_path)) != now
        now = run.digest(str(tmp_path))


@pytest.mark.parametrize("alter", [False, True])
def test_diploid_cell(tmp_path, capsys, monkeypatch, alter):
    """The cell's options reach the program (alternate contigs written and
    polished), its check file's number is on the line, and runs_differ
    sees a window assembly whose a_ctg.fa differs."""
    root = write_root(tmp_path)
    real = run.Program.assemble
    seen = []

    def assemble(self, manifest, outdir, trace):
        rec = real(self, manifest, outdir, trace)
        if os.path.basename(outdir).startswith("asm"):
            seen.append([os.path.exists(os.path.join(outdir, f))
                         for f in ALT])
            if alter and outdir.endswith("asm001"):
                with open(os.path.join(outdir, ALT[0]), "a") as f:
                    f.write(">altered\nACGT\n")
        return rec

    monkeypatch.setattr(run.Program, "assemble", assemble)
    monkeypatch.setattr(run, "drive", lambda one, seconds: [one(0), one(1)])
    line = run_cell(root, capsys)
    assert seen == [[True, True]] * 2
    checks = line["checks"]
    assert list(checks) == list(CELL["limits"])
    assert checks["insertion_miss"]["limit"] == 50.0
    assert checks["runs_differ"]["value"] == int(alter)
    assert line["correct"] == (not alter), checks
    if not alter:   # the run's reads: none crosses a junction
        g = gen.genome(SEED, CONFIG, root=str(root))
        *_, layout = gen.write_reads(SEED, CONFIG, g, str(tmp_path / "r"),
                                     20000)
        lens = np.array([len(s) for s in g.seqs])
        assert set(layout[:, 3].tolist()) == {0, 1}
        assert (layout[:, 0] + layout[:, 1] <= lens[layout[:, 3]]).all()


def test_a_check_that_loads_jax_refuses_the_run(tmp_path, capsys,
                                                 monkeypatch):
    """A forbidden module that a check file loads after the window is
    found before the result line: the run exits 4 and prints no line."""
    cell = dict(CELL, limits=dict(CELL["limits"], loads_flax=0.0))
    root = write_root(tmp_path, cell=cell)
    monkeypatch.setattr(run, "drive", lambda one, seconds: [one(0)])
    args = run.parse(["--workload", "diploid.alt", "--seed", str(SEED),
                      "--seconds", "1"])
    assert "flax" not in sys.modules
    try:
        rc = run.run(args, device="cpu", require_chip=False, root=str(root),
                     bench_path=str(tmp_path / "BENCHMARK.json"))
    finally:
        sys.modules.pop("flax", None)
    out, err = capsys.readouterr()
    assert rc == 4 and "loaded flax" in err
    assert '"correct"' not in out


def _bad(case):
    cfg = json.loads(json.dumps(CONFIG))
    cell = json.loads(json.dumps(CELL))
    if case == "model":
        cfg["genome"]["model"] = "two_haplotype"
    elif case == "field":
        cell["asm_config"]["alt_cns_min_sise"] = 1000
    elif case == "set_field":
        cell["asm_config"]["k"] = 20
    elif case in ("hybrid_overlap", "mesh", "shard_overlap"):
        cell["asm_config"][case] = True
    elif case == "spill_dir":
        cell["asm_config"][case] = "spill"
    elif case == "argument":
        cell["assembly"] = {"with_alts": True}
    elif case == "profile_dir":
        cell["assembly"][case] = "profile"
    elif case == "check":
        cell["limits"]["insertion_mis"] = 50.0
    elif case == "one_sequence":
        cell["limits"]["genome_miss"] = 1.0
    return cfg, cell


@pytest.mark.parametrize("case,match", [
    ("model", "genomes/two_haplotype.py"),
    ("field", "'alt_cns_min_sise', which is no field of AsmConfig"),
    ("set_field", "'k', which the settings, the route flags"),
    ("hybrid_overlap", "'hybrid_overlap', which the settings, the route"),
    ("mesh", "'mesh', which the settings, the route flags"),
    ("shard_overlap", "'shard_overlap', which the settings, the route"),
    ("spill_dir", "'spill_dir', which the settings, the route flags"),
    ("argument", "'with_alts', which is no argument of Assembly"),
    ("profile_dir", "'profile_dir', which is no argument of Assembly"),
    ("check", "checks/insertion_mis.py"),
    ("metric", "metrics/no_such_metric.py"),
    ("one_sequence", "genome_miss places contigs on a genome of one")])
def test_a_typo_fails_before_any_reads(tmp_path, monkeypatch, case, match):
    cfg, cell = _bad(case)
    root = write_root(tmp_path, cfg, cell, extra_metric=case == "metric")

    def written(*a, **k):
        raise AssertionError("reads were written")

    monkeypatch.setattr(gen, "write_reads", written)
    monkeypatch.setattr(gen, "simulate_seqs", written)
    args = run.parse(["--workload", "diploid.alt", "--seed", str(SEED),
                      "--seconds", "1"])
    with pytest.raises(ValueError, match=match):
        run.run(args, device="cpu", require_chip=False, root=str(root),
                bench_path=str(tmp_path / "BENCHMARK.json"))
