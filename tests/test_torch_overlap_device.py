"""Stage 2 on the device, run on the CPU: the port's device overlap
backends and the segmented index build against the JAX package.

Shapes of the reference's tests/test_overlap_device.py (30 kb genome,
3 kb reads, 12x, k=12 w=24 r=4).  overlap_all_spec(backend="device")
and overlap_chunk_device give the JAX package's records byte for byte,
and Assembly with use_device_aligner and device_pairs its preads.ovl and
p_ctg.fa; the hybrid paths, whose split between the device and the host
aligner varies run to run, agree with the host backend at pair level
(Jaccard > 0.9), as the reference's tests demand.  The segmented build
equals one build, in the arrays and the .dat bytes, and the JAX
package's segmented build in-process.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import index as jax_index
from peregrine_tpu.ops import overlap as jax_overlap
from peregrine_tpu.pipeline.run import Assembly as JaxAssembly
from peregrine_tpu_torch import cli
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import device_align
from peregrine_tpu_torch.ops import overlap as ov
from peregrine_tpu_torch.ops.index import build_index, build_index_segmented
from peregrine_tpu_torch.pipeline.run import Assembly
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

CFG = dict(k=12, w=24, r=4, levels=2, min_ovlp_aln=300, sketch_pad_len=8192,
           sketch_batch=16, aln_batch=64, aln_max_len=8192)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    cfg, jcfg = AsmConfig(**CFG), JaxConfig(**CFG)
    db, jdb = SeqDB.from_reads(reads), JaxSeqDB.from_reads(reads)
    return reads, cfg, jcfg, db, jdb, build_index(db, cfg, "cpu"), \
        jax_index.build_index(jdb, jcfg)


def _pairs(recs):
    return {tuple(sorted((int(o["y0"] >> np.uint64(32)),
                          int(o["y1"] >> np.uint64(32))))) for o in recs}


def _jaccard(a, b):
    a, b = _pairs(a), _pairs(b)
    return len(a & b) / max(len(a | b), 1)


def _same_records(a, b):
    assert a.dtype == b.dtype and len(a) == len(b)
    assert a.tobytes() == b.tobytes()


def test_spec_device_backend_matches_jax(data):
    _, cfg, jcfg, db, jdb, idx, jidx = data
    got = ov.overlap_all_spec(db, idx, cfg, n_workers=2, backend="device",
                              device="cpu")
    want = jax_overlap.overlap_all_spec(jdb, jidx, jcfg, n_workers=2,
                                        backend="device")
    assert len(got) > 100
    _same_records(got, want)
    host = ov.overlap_all_spec(db, idx, cfg, n_workers=2, backend="host")
    assert _jaccard(host, got) > 0.9


def test_chunk_device_matches_jax(data):
    _, cfg, jcfg, db, jdb, idx, jidx = data
    before = device_align.myers_batch_db.launches
    got = ov.overlap_chunk_device(db, idx, cfg, "cpu")
    assert device_align.myers_batch_db.launches == before  # plain route
    _same_records(got, jax_overlap.overlap_chunk_device(jdb, jidx, jcfg))


def test_lanes_past_aln_max_len_align_natively(data, monkeypatch):
    """Requests longer than aln_max_len never reach the aligner: with the
    cap below every read, the device backend aligns nothing, the final
    pass aligns everything natively, and the records are the host
    backend's."""
    _, cfg, _, db, _, idx, _ = data
    cfg = cfg.replace(aln_max_len=1000)

    def nothing(pdb, cols, **kw):
        assert len(cols) == 0, "a lane past aln_max_len reached the aligner"
        z = torch.zeros(0, dtype=torch.int32)
        return z, z, z

    monkeypatch.setattr(device_align, "myers_batch_db", nothing)
    got = ov.overlap_all_spec(db, idx, cfg, n_workers=2, backend="device",
                              device="cpu")
    _same_records(got, ov.overlap_all_spec(db, idx, cfg, n_workers=2,
                                           backend="host"))


def test_hybrid_paths_match_host(data):
    _, cfg, _, db, _, idx, _ = data
    host = ov.overlap_all_spec(db, idx, cfg, n_workers=2, backend="host")
    hyb = ov.overlap_all_spec(db, idx, cfg, n_workers=2, backend="hybrid",
                              device="cpu")
    assert _jaccard(host, hyb) > 0.9
    host_chunks = ov.overlap_all(db, idx, cfg, n_chunks=4, n_workers=2,
                                 dedup=False)
    hyb_chunks = ov.overlap_all_hybrid(db, idx, cfg, "cpu", n_chunks=4,
                                       n_host_workers=2)
    assert _jaccard(host_chunks, hyb_chunks) > 0.9


def test_assembly_device_stage2_matches_jax(data, tmp_path):
    """Assembly with use_device_aligner and device_pairs in both
    packages: byte-identical preads.ovl and p_ctg.fa."""
    reads = data[0]
    kw = dict(CFG, min_len=2000, use_device_aligner=True, device_pairs=True)
    Assembly(str(tmp_path / "torch"), AsmConfig(**kw),
             device="cpu").run_draft(reads=reads)
    JaxAssembly(str(tmp_path / "jax"), JaxConfig(**kw)).run_draft(reads=reads)
    for f in ("1-index/shmr-L2-01-of-01.dat", "2-ovlp/preads.ovl",
              "3-asm/p_ctg.fa"):
        assert filecmp.cmp(str(tmp_path / "torch" / f),
                           str(tmp_path / "jax" / f), shallow=False), f
    with open(tmp_path / "torch" / "3-asm" / "p_ctg.fa") as f:
        assert f.read().count(">") >= 1


@pytest.mark.parametrize("flags", [["--device-aligner", "--device-pairs"],
                                   ["--hybrid-overlap"],
                                   ["--hybrid-overlap", "--device-pairs"]])
def test_cli_runs_the_device_flags(data, tmp_path, flags):
    reads = data[0]
    lst = str(tmp_path / "reads.lst")
    write_reads(reads, str(tmp_path / "reads.fa"), lst)
    out = str(tmp_path / "wd")
    assert cli.main(["asm", lst, "--output", out, "--device", "cpu",
                     "--shimmer-k", "12", "--shimmer-w", "24",
                     "--shimmer-r", "4", "--min_len", "2000"] + flags) == 0
    with open(os.path.join(out, "2-ovlp", "preads.ovl")) as f:
        assert sum(1 for _ in f) > 10
    with open(os.path.join(out, "config.json")) as f:
        text = f.read()
    assert ('"use_device_aligner": true' in text) == (
        "--device-aligner" in flags)
    assert ('"device_pairs": true' in text) == ("--device-pairs" in flags)


def test_segmented_build_matches_one_build(data, tmp_path, monkeypatch):
    """Segments of a small budget (many groups, and a read larger than
    the budget) give one build's arrays and .dat bytes, and the JAX
    package's in-process segmented build."""
    _, cfg, jcfg, db, jdb, idx, _ = data
    for budget in (50_000, 2_000):
        seg = build_index_segmented(db, cfg, "cpu", budget)
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(seg, f), getattr(idx, f))
    seg.save(str(tmp_path / "seg"), level=2)
    idx.save(str(tmp_path / "one"), level=2)
    for f in ("L2-01-of-01.dat", "L2-MC-01-of-01.dat"):
        assert filecmp.cmp(str(tmp_path / f"seg-{f}"),
                           str(tmp_path / f"one-{f}"), shallow=False)
    monkeypatch.setenv("PG_INDEX_SUBPROC", "0")
    jseg = jax_index.build_index_segmented(jdb, jcfg, budget_bytes=50_000)
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(seg, f), getattr(jseg, f))
    with pytest.raises(AssertionError):
        build_index_segmented(db, cfg, "cpu", 50_000, keep_l0=True)


def test_pipeline_indexes_past_the_budget_in_segments(data, tmp_path,
                                                      monkeypatch, caplog):
    """A seqdb past the device budget is indexed in segments (it raised
    before) and gives the index files of one build; with device_pairs the
    budget is 60% of it."""
    import logging

    from peregrine_tpu_torch.pipeline.run import _device_db_budget
    reads, cfg, _, db, _, idx, _ = data
    monkeypatch.setenv("PG_HBM_DB_BUDGET", "100000")
    assert _device_db_budget(torch.device("cpu"), cfg) == 100000
    assert _device_db_budget(torch.device("cpu"),
                             cfg.replace(device_pairs=True)) == 60000
    with caplog.at_level(logging.INFO, logger="peregrine_tpu_torch"):
        asm = Assembly(str(tmp_path / "wd"), cfg, device="cpu")
        asm.build_db(reads=reads)
        got = asm.build_shimmer_index()
    assert "indexing in segments" in caplog.text
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(idx, f))
