"""The port's api.py, verify.py and the rest of Assembly, held to the JAX
package on the CPU.

api: the cases of tests/test_api.py through both packages (the port on
the cpu device) with identical arrays, chains, tags and consensus bytes.
verify: verify_contig and verify_contigs_multi give the same results.
Assembly: assemble(reads=) and Assembly.run(with_consensus=True) write the
same p_ctg.fa and p_ctg_cns.fa as the JAX package's, build_db(reads_iter=)
the same seqdb bytes as build_db(reads_list=), and run() under
profile_dir a torch.profiler trace.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from peregrine_tpu import api as japi
from peregrine_tpu import verify as jverify
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.pipeline import run as jrun
from peregrine_tpu_torch import api, verify
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import revcomp
from peregrine_tpu_torch.pipeline import run
from peregrine_tpu_torch.simdata import (mutate, random_genome,
                                         simulate_reads, write_reads)

torch.set_num_threads(2)
CPU = "cpu"


def _same_arrays(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_get_shimmers_from_seq_matches_jax(levels):
    rng = np.random.default_rng(42)
    seq = random_genome(rng, 5000)
    got = api.get_shimmers_from_seq(seq, rid=3, levels=levels,
                                    reduction_factor=3, device=CPU)
    _same_arrays(got, japi.get_shimmers_from_seq(
        seq, rid=3, levels=levels, reduction_factor=3))
    assert len(got[0]) > 0 and (got[1] >> np.uint64(32) == 3).all()


def test_get_shimmers_short_and_large_rid():
    """Below the 64-column floor, and a rid past 2^31 (uint32 in the JAX
    package, int64 here)."""
    rng = np.random.default_rng(1)
    for seq, rid in ((random_genome(rng, 40), 5),
                     (random_genome(rng, 3000), (1 << 31) + 7)):
        got = api.get_shimmers_from_seq(seq, rid=rid, levels=1, k=12, w=10,
                                        device=CPU)
        _same_arrays(got, japi.get_shimmers_from_seq(seq, rid=rid, levels=1,
                                                     k=12, w=10))
    assert len(got[1]) and (got[1] >> np.uint64(32) == rid).all()
    with pytest.raises(ValueError, match="at most 2"):
        api.get_shimmers_from_seq(seq, levels=3, device=CPU)


@pytest.mark.parametrize("direction", [0, 1])
def test_get_shimmer_alns_matches_jax(direction):
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 8000)
    if direction == 0:
        a, b = genome[:6000], mutate(rng, genome[2000:8000], 0.01)
    else:
        a, b = genome, revcomp(mutate(rng, genome[1000:7000], 0.01))
    sh = [api.get_shimmers_from_seq(s, rid=i, device=CPU)
          for i, s in enumerate((a, b))]
    jsh = [japi.get_shimmers_from_seq(s, rid=i) for i, s in enumerate((a, b))]
    for g, j in zip(sh, jsh):
        _same_arrays(g, j)
    got = api.get_shimmer_alns(*sh, direction=direction)
    assert got == japi.get_shimmer_alns(*jsh, direction=direction)
    best = max(got, key=lambda x: len(x[0]))
    assert len(best[0]) >= 3
    if direction == 0:
        assert abs(best[2] - 2000) < 150


def test_get_tag_and_cluster_consensus_match_jax():
    rng = np.random.default_rng(42)
    template = random_genome(rng, 3000)
    read = mutate(rng, template, 0.02)
    for offset in (0, 40, -40):
        got = api.get_tag_from_seqs(read, template, offset)
        assert got == japi.get_tag_from_seqs(read, template, offset)
    assert got is not None and len(got) > 2500
    reads = [template] + [mutate(rng, template, 0.02) for _ in range(8)]
    reads = [r if i % 2 == 0 else revcomp(r) for i, r in enumerate(reads)]
    cns = api.get_cns_from_reads(reads, device=CPU)
    assert cns == japi.get_cns_from_reads(reads)
    from peregrine_tpu_torch.native import dw_align
    aln = dw_align(cns.upper(), template, 100, get_aln_str=False)
    assert aln.aln_q_e > 2900
    assert 1 - aln.dist / max(aln.aln_q_e, 1) > 0.998


def test_api_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.get_shimmers_from_seq(b"ACGT" * 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.get_cns_from_reads([b"ACGT" * 100])


def test_verify_contig_matches_jax():
    rng = np.random.default_rng(5)
    g = random_genome(rng, 200_000)
    contig = bytearray(g[70_000:] + g[:70_000])
    for pos in (10_000, 90_000, 150_000):
        contig[pos] = ord("A") if contig[pos] != ord("A") else ord("C")
    del contig[120_000]
    contig.insert(44_000, ord("T"))
    for c, circular in ((bytes(contig), True),
                        (verify.revcomp_bytes(bytes(contig)), True),
                        (g[20_000:180_000], False)):
        got = verify.verify_contig(c, g, circular=circular)
        assert got == jverify.verify_contig(c, g, circular=circular)
        assert got["anchored"]
    assert got["exact"] and got["genome_pos"] == 20_000
    chroms = [g[:100_000], g[100_000:]]
    ctgs = {"a": chroms[1], "b": verify.revcomp_bytes(chroms[0])}
    assert verify.verify_contigs_multi(ctgs, chroms, min_len=50_000) \
        == jverify.verify_contigs_multi(ctgs, chroms, min_len=50_000)


# --- the rest of Assembly ------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """tests/test_torch_pipeline.py's small k12 shape: reads, their
    manifest, and the JAX package's Assembly.run(with_consensus=True)."""
    d = tmp_path_factory.mktemp("asm")
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=8.0)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    kw = dict(k=12, w=24, r=4, levels=2, min_len=2000, sketch_pad_len=8192,
              sketch_batch=16)
    jax_wd = str(d / "jax")
    jrun.Assembly(jax_wd, JaxConfig(**kw)).run(reads=reads,
                                               with_consensus=True)
    return d, reads, lst, AsmConfig(**kw), jax_wd


def test_assemble_matches_jax(small):
    d, reads, _, cfg, jax_wd = small
    fa = run.assemble(reads=reads, outdir=str(d / "assemble"), cfg=cfg,
                      device=CPU)
    assert fa == str(d / "assemble" / "3-asm" / "p_ctg.fa")
    assert filecmp.cmp(fa, os.path.join(jax_wd, "3-asm", "p_ctg.fa"),
                       shallow=False)


def test_run_with_consensus_and_profile_matches_jax(small):
    """run(reads_list=, with_consensus=True) under profile_dir: the JAX
    package's p_ctg.fa and p_ctg_cns.fa, and a trace of host events (the
    cpu device traces the host alone)."""
    d, _, lst, cfg, jax_wd = small
    wd, prof = str(d / "run"), str(d / "prof")
    fa = run.Assembly(wd, cfg, device=CPU, profile_dir=prof).run(
        reads_list=lst, with_consensus=True)
    assert fa == os.path.join(wd, "4-cns", "p_ctg_cns.fa")
    for f in ("3-asm/p_ctg.fa", "4-cns/p_ctg_cns.fa"):
        assert filecmp.cmp(os.path.join(wd, f), os.path.join(jax_wd, f),
                           shallow=False), f
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("ph") == "X"}
    assert "cpu_op" in cats and "kernel" not in cats


def test_build_db_from_iter(small):
    """build_db(reads_iter=) streams the same seqdb bytes as
    build_db(reads_list=); an existing seqdb is opened, not rebuilt."""
    d, reads, lst, cfg, _ = small
    paths = {}
    for name, kw in (("from_list", dict(reads_list=lst)),
                     ("from_iter", dict(reads_iter=iter(reads)))):
        asm = run.Assembly(str(d / name), cfg, device=CPU)
        db = asm.build_db(**kw)
        assert len(db) == len(reads)
        paths[name] = str(d / name / "0-seqdb" / "seq_dataset")
    for ext in (".seqdb", ".idx"):
        assert filecmp.cmp(paths["from_list"] + ext, paths["from_iter"] + ext,
                           shallow=False), ext
    again = run.Assembly(str(d / "from_iter"), cfg, device=CPU).build_db(
        reads_iter=iter(()))
    assert len(again) == len(reads)


def test_profile_refuses_cuda_without_card_tracing(monkeypatch, tmp_path):
    """Asked to trace a cuda device where the profiler cannot trace one,
    profiled() raises instead of tracing the host alone."""
    import torch.profiler as tp
    monkeypatch.setattr(tp, "supported_activities",
                        lambda: {tp.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUPTI"):
        with run.profiled(str(tmp_path), torch.device("cuda")):
            pass
    assert not os.listdir(tmp_path)
