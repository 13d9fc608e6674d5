"""`asm --with-consensus` through both packages on the CPU: identical
outputs, stage 4 included.

The JAX package's CLI and the port's CLI (--device cpu) run on the same
simulated reads (a 30 kb genome, 10x of 3 kb reads): at k=28 with the
level-0 index (the wide sketch and reduce_impl, so compact_planes in
stage 1 and in stage 4's contig index), and at k=12 with --with-alt and
the level-0 index (the packed kernels).  Every output file must be
byte-identical.  These genomes have no bubbles, so --with-alt writes an
empty alt tiling path and no alt contigs; the alt polish is held to the
JAX package by test_alt_polish_matches_jax.  Also: a JAX-written
output directory through 3-asm/ polished by the port, and the external
grouped mapping route.
"""

import filecmp
import os
import shutil
import time

import numpy as np
import pytest
import torch

from peregrine_tpu import cli as jax_cli
from peregrine_tpu_torch import cli
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

BASE = ["--shimmer-w", "24", "--shimmer-r", "4", "--min_len", "2000"]
SHAPES = {
    "k28-L0": ["--shimmer-k", "28", "--with-L0-index", "--with-consensus"],
    "k12-alt": ["--shimmer-k", "12", "--with-consensus", "--with-alt",
                "--with-L0-index"],
}
STAGE4 = ("4-cns/read_map.txt", "4-cns/p_ctg_cns.fa")
# written by neither package on these shapes (no bubbles, so no alt contigs)
ABSENT = ("3-asm/a_ctg.fa", "4-cns-alt/a_ctg_cns.fa")
COMMON = ("1-index/shmr-L0-01-of-01.dat", "1-index/shmr-L0-MC-01-of-01.dat",
          "1-index/shmr-L2-01-of-01.dat", "1-index/shmr-L2-MC-01-of-01.dat",
          "2-ovlp/preads.ovl", "3-asm/p_ctg.fa", "3-asm/a_ctg_tiling_path",
          "config.json") + STAGE4


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The reads and the JAX package's `asm` output for each shape."""
    d = tmp_path_factory.mktemp("cns")
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 30_000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=10.0)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    for name, flags in SHAPES.items():
        assert jax_cli.main(["asm", lst, "--output", str(d / f"jax-{name}")]
                            + BASE + flags) == 0
    return d, lst


def _same(a, b, names):
    compared = 0
    for f in names:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        assert os.path.exists(pa) == os.path.exists(pb), f
        if os.path.exists(pa):
            assert filecmp.cmp(pa, pb, shallow=False), f
            compared += 1
    return compared


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_consensus_asm_matches_jax(jax_runs, shape):
    d, lst = jax_runs
    out = str(d / f"torch-{shape}")
    assert cli.main(["asm", lst, "--output", out, "--device", "cpu"]
                    + BASE + SHAPES[shape]) == 0
    jax_out = str(d / f"jax-{shape}")
    assert _same(jax_out, out, COMMON) == len(COMMON)
    for f in ABSENT:
        assert not os.path.exists(os.path.join(jax_out, f)), f
        assert not os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "4-cns", "p_ctg_cns.fa")) as f:
        assert f.read().count(">") >= 1


def test_port_polishes_jax_draft(jax_runs):
    """A JAX-written work directory through 3-asm/ resumes in the port:
    stages 0-3 (the level-0 index included) are loaded untouched and
    stage 4 comes out identical."""
    d, lst = jax_runs
    src = str(d / "jax-k28-L0")
    wd = str(d / "resumed")
    shutil.copytree(src, wd)
    shutil.rmtree(os.path.join(wd, "4-cns"))
    kept = [os.path.join(wd, p) for p in
            ("0-seqdb/seq_dataset.seqdb", "0-seqdb/seq_dataset.idx",
             "1-index/shmr-L0-01-of-01.dat", "1-index/shmr-L2-01-of-01.dat",
             "2-ovlp/preads.ovl", "3-asm/p_ctg.fa")]
    mtimes = {p: os.path.getmtime(p) for p in kept}
    time.sleep(0.05)
    assert cli.main(["asm", lst, "--output", wd, "--device", "cpu"]
                    + BASE + SHAPES["k28-L0"]) == 0
    assert _same(src, wd, STAGE4) == len(STAGE4)
    for p in kept:
        assert os.path.getmtime(p) == mtimes[p], f"{p} was recomputed"


def test_external_mapping_polishes_identically(jax_runs, monkeypatch):
    """PG_MAP_EXTERNAL=1 takes the disk-backed grouped mapping (the route
    of seqdbs above 8 GB): the same polished contigs as the JAX package's
    in-memory route."""
    d, lst = jax_runs
    out = str(d / "torch-external")
    monkeypatch.setenv("PG_MAP_EXTERNAL", "1")
    assert cli.main(["asm", lst, "--output", out, "--device", "cpu"]
                    + BASE + SHAPES["k28-L0"]) == 0
    assert os.path.exists(os.path.join(out, "4-cns", "read_map.npy"))
    assert os.path.getsize(os.path.join(out, "4-cns", "read_map.txt")) > 0
    assert _same(str(d / "jax-k28-L0"), out, ("4-cns/p_ctg_cns.fa",)) == 1


def test_alt_polish_matches_jax(tmp_path):
    """The --with-alt polish of a_ctg.fa into 4-cns-alt/ (gated at 500 kB,
    so the gate is lowered here and the draft stands in for a_ctg.fa):
    the Assembly API of both packages, byte-identical outputs."""
    from peregrine_tpu.config import AsmConfig as JaxConfig
    from peregrine_tpu.pipeline.run import Assembly as JaxAssembly
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.pipeline.run import Assembly

    rng = np.random.default_rng(3)
    genome = random_genome(rng, 30_000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=10.0)
    cfg = dict(k=20, w=24, r=4, levels=2, min_len=2000, sketch_pad_len=8192,
               sketch_batch=16, alt_cns_min_size=0)
    outs = {}
    for name, asm in (("jax", JaxAssembly(str(tmp_path / "jax"),
                                          JaxConfig(**cfg), with_alt=True)),
                      ("torch", Assembly(str(tmp_path / "torch"),
                                         AsmConfig(**cfg), device="cpu",
                                         with_alt=True))):
        fa = asm.run_draft(reads=reads)
        shutil.copy(fa, os.path.join(os.path.dirname(fa), "a_ctg.fa"))
        asm.build_consensus(n_workers=2)
        outs[name] = str(tmp_path / name)
    names = ("3-asm/p_ctg.fa",) + STAGE4 + ("4-cns-alt/read_map.txt",
                                            "4-cns-alt/a_ctg_cns.fa")
    assert _same(outs["jax"], outs["torch"], names) == len(names)


def test_shimmer_k_outside_range_exits_nonzero(tmp_path, capsys):
    for k in ("0", "29"):
        with pytest.raises(SystemExit) as exc:
            cli.main(["asm", "reads.lst", "--output", str(tmp_path / "wd"),
                      "--device", "cpu", "--shimmer-k", k])
        assert exc.value.code != 0
        assert "1..28" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "wd")
