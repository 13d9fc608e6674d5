"""The port's low-memory (spill) mode on the CPU, held to the JAX package.

Shapes of the reference's spill tests (tests/test_modes.py,
tests/test_overlap.py): a 40 kb genome, 14x of 4 kb reads, k=12 w=24 r=4.
The spilled pair map and bucket stream equal the in-memory ones and are
memmaps, and the overlap stage over them gives the JAX package's
records; PG_MEM_BUDGET engages auto-spill with unchanged outputs; the
spill preflight fails fast and PG_SPILL_PREFLIGHT=0 opts out; and the
stage-2/4 pair-map sharing rule (the spill filesystem must have 0.55x
the seqdb bytes free) shares the map or rebuilds it, with stage 4's
outputs equal to the JAX package's under the same free space.
"""

import filecmp
import logging
import os

import numpy as np
import pytest
import torch

from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import index as jax_index
from peregrine_tpu.ops import overlap as jax_overlap
from peregrine_tpu.pipeline import run as jax_run
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import mapping as torch_mapping
from peregrine_tpu_torch.ops import overlap as ov
from peregrine_tpu_torch.ops.index import build_index
from peregrine_tpu_torch.pipeline import run as torch_run
from peregrine_tpu_torch.simdata import random_genome, simulate_reads

torch.set_num_threads(2)

CFG = dict(k=12, w=24, r=4, levels=2, min_len=2500, sketch_pad_len=8192,
           sketch_batch=16)
DRAFT = ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa")
STAGE4 = ("4-cns/read_map.txt", "4-cns/p_ctg_cns.fa")


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 40000)
    reads, _ = simulate_reads(rng, genome, read_len=4000, coverage=14.0)
    return reads


def _same(a, b, names):
    for f in names:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


def test_spilled_pairs_and_stream_match(reads, tmp_path):
    """build_pairs and bucket_stream with spill_dir give the in-memory
    arrays as memmaps; overlap_all_spec over the spilled map gives the
    in-memory map's records and the JAX package's."""
    cfg = AsmConfig(**CFG, min_ovlp_aln=300)
    jcfg = JaxConfig(**CFG, min_ovlp_aln=300)
    db, jdb = SeqDB.from_reads(reads), JaxSeqDB.from_reads(reads)
    idx = build_index(db, cfg, "cpu")
    spill = str(tmp_path / "spill")
    os.makedirs(spill)
    a = ov.build_pairs(idx, db.lengths)
    b = ov.build_pairs(idx, db.lengths, spill_dir=spill)
    assert len(a[0]) > 0
    for x, y in zip(a, b):
        assert isinstance(y, np.memmap)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    sa = ov.bucket_stream(a[0], a[1], a[2], a[4], cfg.ovlp_upper)
    sb = ov.bucket_stream(b[0], b[1], b[2], b[4], cfg.ovlp_upper,
                          spill_dir=spill)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    r1 = ov.overlap_all_spec(db, idx, cfg, n_workers=2, pairs=a)
    r2 = ov.overlap_all_spec(db, idx, cfg.replace(spill_dir=spill),
                             n_workers=2, pairs=b)
    jidx = jax_index.build_index(jdb, jcfg)
    want = jax_overlap.overlap_all_spec(
        jdb, jidx, jcfg.replace(spill_dir=spill), n_workers=2,
        pairs=jax_overlap.build_pairs(jidx, jdb.lengths, spill_dir=spill))
    assert len(r1) > 0
    assert r1.tobytes() == r2.tobytes() == want.tobytes()


def test_auto_spill_engages_and_matches_jax(reads, tmp_path, monkeypatch):
    """PG_MEM_BUDGET=1000000 engages auto-spill (outdir/spill); preads.ovl
    and p_ctg.fa equal the unspilled run's and the JAX package's spilled
    run's."""
    monkeypatch.delenv("PG_MEM_BUDGET", raising=False)
    big = torch_run.Assembly(str(tmp_path / "big"), AsmConfig(**CFG),
                             device="cpu")
    big.run_draft(reads=reads)
    assert big.cfg.spill_dir is None
    monkeypatch.setenv("PG_MEM_BUDGET", "1000000")
    tiny = torch_run.Assembly(str(tmp_path / "tiny"), AsmConfig(**CFG),
                              device="cpu")
    tiny.run_draft(reads=reads)
    assert tiny.cfg.spill_dir == str(tmp_path / "tiny" / "spill")
    assert os.path.isdir(tiny.cfg.spill_dir)
    jax_run.Assembly(str(tmp_path / "jax"), JaxConfig(**CFG)).run_draft(
        reads=reads)
    _same(str(tmp_path / "big"), str(tmp_path / "tiny"), DRAFT)
    _same(str(tmp_path / "jax"), str(tmp_path / "tiny"), DRAFT)


def test_spill_preflight_fails_fast(reads, tmp_path, monkeypatch):
    """A spill filesystem with 4096 bytes free stops auto-spill before
    any overlap work; PG_SPILL_PREFLIGHT=0 lets the run complete."""
    monkeypatch.setenv("PG_MEM_BUDGET", "1000000")
    monkeypatch.setattr(torch_run, "_spill_free_bytes", lambda d: 4096)
    asm = torch_run.Assembly(str(tmp_path / "wd"), AsmConfig(**CFG),
                             device="cpu")
    with pytest.raises(RuntimeError, match="spill preflight"):
        asm.run_draft(reads=reads)
    assert not os.path.exists(str(tmp_path / "wd/2-ovlp/preads.ovl"))
    monkeypatch.setenv("PG_SPILL_PREFLIGHT", "0")
    asm2 = torch_run.Assembly(str(tmp_path / "wd2"), AsmConfig(**CFG),
                              device="cpu")
    assert os.path.exists(asm2.run_draft(reads=reads))


@pytest.mark.parametrize("share", [True, False], ids=["sharing",
                                                      "not-sharing"])
def test_pair_map_sharing_rule(reads, tmp_path, monkeypatch, caplog, share):
    """With --spill-dir, stage 2 keeps its pair map for stage 4 when the
    spill filesystem has 0.55x the seqdb bytes free, and stage 4 builds
    none; below that (above the 0.22x preflight) stage 2 frees its map
    and stage 4 rebuilds it.  Stage 4's outputs equal the JAX package's
    under the same free space."""
    nbytes = SeqDB.from_reads(reads).data.nbytes
    free = int((0.6 if share else 0.3) * nbytes)
    for mod in (torch_run, jax_run):
        monkeypatch.setattr(mod, "_spill_free_bytes", lambda d: free)
    builds = []
    real = ov.build_pairs

    def counted(*a, **kw):
        builds.append(kw.get("spill_dir"))
        return real(*a, **kw)

    monkeypatch.setattr(ov, "build_pairs", counted)
    monkeypatch.setattr(torch_mapping, "build_pairs", counted)
    caplog.set_level(logging.INFO, logger="peregrine_tpu_torch")

    spill = str(tmp_path / "spill-torch")
    asm = torch_run.Assembly(str(tmp_path / "torch"),
                             AsmConfig(**CFG, spill_dir=spill), device="cpu")
    asm.run_draft(reads=reads)
    said = [r.getMessage() for r in caplog.records]
    spill_mode = [m for m in said if m.startswith("overlap spill mode: ")]
    assert len(spill_mode) == 1
    assert spill_mode[0].startswith("overlap spill mode: "
                                    + ("sharing" if share else "not sharing"))
    assert any(m.startswith("stage 2 overlap: ") and "spill free" in m
               for m in said)
    assert (asm._pairs is not None) == share
    if share:
        assert all(isinstance(x, np.memmap) for x in asm._pairs)
    assert builds == [spill]
    caplog.clear()
    asm.build_consensus()
    assert asm._pairs is None
    stage4 = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("stage 4 contig index: ")]
    assert len(stage4) == 1
    assert ("the pair map is rebuilt next" in stage4[0]) != share
    # stage 4 maps with the shared map, or rebuilds it, spilled again
    assert builds == ([spill] if share else [spill, spill])

    jasm = jax_run.Assembly(str(tmp_path / "jax"),
                            JaxConfig(**CFG, spill_dir=str(tmp_path / "sj")))
    jasm.run_draft(reads=reads)
    assert (jasm._pairs is not None) == share
    jasm.build_consensus()
    _same(str(tmp_path / "jax"), str(tmp_path / "torch"), DRAFT + STAGE4)
