"""The stage-0 seqdb uploader against the JAX package's, on the CPU.

SeqDBUploader("cpu") and upload_seqdb give the JAX package's
SeqDBUploader and upload_seqdb planes, in shape and byte for byte
(tolerance 0): fed in the JAX package's test plan and in one chunk, a
tail under 1024 bases or nothing, with and without ambiguous bases (the
amb plane elided or copied), with pieces of the default size and pieces
so small that they flush in the middle of every chunk (packed in small
parts on several threads); through both
build_to_disk routes (the Python loop, and the native encoder's feeder
thread).  Pieces past a plane's allocation grow it and a plane allocated
larger is cut to its class.  A ragged chunk before the last, and an
error of the worker, raise at finish().

Stage 1 takes the planes: an Assembly on the CPU whose stage 0 starts
the uploader (the start condition patched, since it asks for a card)
writes the JAX package's 1-index files, with and without the level-0
index; the planes are gone once stage 1 returns, and are dropped before
a segmented build and a resumed stage 1.  The start condition gives the
JAX package's answers for a card and the CPU, a mesh, and a manifest
past the device budget.
"""

import filecmp
import gc
import logging
import os
import weakref

import numpy as np
import pytest
import torch

import jax
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import dbgather as jdb
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.pipeline.run import Assembly as JaxAssembly
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import dbgather
from peregrine_tpu_torch.parallel.mesh import make_mesh
from peregrine_tpu_torch.pipeline import run as prun
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

N = 3 * 1024 * 17 + 531  # tests/test_dbgather.py's seqdb length
# feed plans: chunk lengths before the rest of the data, which is the
# last chunk (none where the plan has eaten it all)
PLANS = {"test_dbgather": (1024, 5 * 1024, 16 * 1024, 2 * 1024),
         "one_chunk": (), "tail_only": (), "empty": ()}
LENGTHS = {"test_dbgather": N, "one_chunk": N, "tail_only": 531, "empty": 0}
CFG = dict(k=16, w=24, r=4, levels=2, sketch_pad_len=8192, sketch_batch=16)


def _data(n: int, amb: bool) -> np.ndarray:
    """n 4-bit codec bytes: any nibble (ambiguous codes among them), or
    the four bases alone."""
    rng = np.random.default_rng(n)
    if amb:
        return rng.integers(0, 16, size=n, dtype=np.uint8)
    return rng.choice(np.array([1, 2, 4, 8], np.uint8), size=n)


def _feed(up, data: np.ndarray, plan) -> None:
    pos = 0
    for step in plan:
        up.feed(data[pos:pos + step])
        pos += step
    up.feed(data[pos:])


def _same(got, want) -> None:
    """Two sets of planes (tensors or JAX arrays) are equal in dtype
    (uint8), shape and bytes."""
    for a, b in ((got.fw, want.fw), (got.amb, want.amb)):
        a, b = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in (a, b))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("piece", [None, 256], ids=["piece_default",
                                                    "piece_256"])
@pytest.mark.parametrize("amb", [True, False], ids=["amb", "acgt"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_uploader_and_upload_seqdb_match_jax(monkeypatch, plan, amb, piece):
    """With pieces of 256 fw bytes the chunks are also packed in parts of
    2,048 bases, several at once."""
    if piece:
        monkeypatch.setattr(dbgather.SeqDBUploader, "PIECE_FW_BYTES", piece)
        monkeypatch.setattr(dbgather.SeqDBUploader, "PACK_SPLIT", 2048)
    data = _data(LENGTHS[plan], amb)
    want = jdb.upload_seqdb(data)
    jup = jdb.SeqDBUploader()
    _feed(jup, data, PLANS[plan])
    _same(jup.finish(), want)  # the JAX package agrees with itself

    up = dbgather.SeqDBUploader("cpu", est_bases=len(data))
    _feed(up, data, PLANS[plan])
    got = up.finish()
    _same(got, want)
    _same(dbgather.upload_seqdb(data, "cpu"), want)

    st = up.stats
    fw_bytes = -(-(dbgather.GUARD_BASES + len(data)) // 4)
    amb_bytes = -(-(dbgather.GUARD_BASES + len(data)) // 8)
    assert st["bases"] == len(data)
    assert st["chunks"] == (len(PLANS[plan]) + 1 if len(data) else 0)
    assert st["pad_bytes"] == (got.fw.numel() + got.amb.numel() - fw_bytes
                               - amb_bytes)
    assert st["peak_plane_bytes"] == got.fw.numel() + got.amb.numel()
    if not len(data):
        assert st["copied_bytes"] == st["elided_bytes"] == 0
        return
    assert st["copied_bytes"] + st["elided_bytes"] == fw_bytes + amb_bytes
    # the guard's amb bytes are zero, and so is every amb byte of ACGT
    if not amb:
        assert st["elided_bytes"] == amb_bytes
    elif piece:
        assert 0 < st["elided_bytes"] < amb_bytes
        assert st["pieces"] == -(-fw_bytes // piece)
    else:
        assert st["elided_bytes"] == 0 and st["pieces"] == 1


@pytest.mark.parametrize("est", ["none", "exact", "tenfold"])
def test_uploader_grows_and_cuts_its_planes(monkeypatch, est):
    """With floors of 4 fw rows and 2 amb rows, a plane allocated at the
    floor grows (twice, or more, its old size) as pieces outrun it, and
    one allocated at ten times the data is cut to the data's class: the
    planes equal the one-shot pack padded to those floors."""
    monkeypatch.setattr(dbgather, "_PLANES", {"fw": (4, 4), "amb": (2, 8)})
    data = _data(N, True)
    fw, amb = dbgather.pack_db_np(data)
    n_est = {"none": 0, "exact": N, "tenfold": 10 * N}[est]
    monkeypatch.setattr(dbgather.SeqDBUploader, "PIECE_FW_BYTES", 512)
    up = dbgather.SeqDBUploader("cpu", est_bases=n_est)
    _feed(up, data, PLANS["test_dbgather"])
    got = up.finish()
    np.testing.assert_array_equal(got.fw.numpy(), dbgather._pad_rows(fw, 4))
    np.testing.assert_array_equal(got.amb.numpy(), dbgather._pad_rows(amb, 2))
    final = got.fw.numel() + got.amb.numel()
    if est == "exact":
        assert up.stats["peak_plane_bytes"] == final
    else:
        assert up.stats["peak_plane_bytes"] > final


@pytest.mark.parametrize("amb", [True, False], ids=["with_n", "acgt"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_build_to_disk_feeds_the_uploader(tmp_path, native, amb):
    """build_to_disk's chunk sink (chunk_bases=4096: the Python loop's
    chunks; the native route's feeder thread tails the file) gives the
    planes of the JAX package's uploader on its own build_to_disk."""
    rng = np.random.default_rng(3)
    alphabet = list(b"ACGTN" if amb else b"ACGT")
    probs = [0.24, 0.24, 0.24, 0.24, 0.04] if amb else None
    paths = []
    for j in range(3):
        fa = tmp_path / f"r{j}.fa"
        with open(fa, "w") as f:
            for i in range(40):
                seq = rng.choice(alphabet, size=int(rng.integers(200, 6000)),
                                 p=probs).astype(np.uint8).tobytes()
                f.write(f">r{j}_{i}\n{seq.decode()}\n")
        paths.append(str(fa))
    lst = tmp_path / "r.lst"
    lst.write_text("".join(p + "\n" for p in paths))
    up = dbgather.SeqDBUploader("cpu", est_bases=prun._manifest_bytes(
        str(lst)))
    fed = []

    def sink(chunk):
        fed.append(len(chunk))
        up.feed(chunk)
    db = SeqDB.build_to_disk(str(lst), str(tmp_path / "db"), chunk_sink=sink,
                             chunk_bases=4096, use_native=native)
    got = up.finish()
    jup = jdb.SeqDBUploader()
    jdb_ = JaxSeqDB.build_to_disk(str(lst), str(tmp_path / "jdb"),
                                  chunk_sink=jup.feed, chunk_bases=4096,
                                  use_native=native)
    want = jup.finish()
    assert np.array_equal(np.asarray(db.data), np.asarray(jdb_.data))
    _same(got, want)
    _same(got, jdb.upload_seqdb(np.asarray(jdb_.data)))
    assert sum(fed) == len(db.data)
    assert all(n % 1024 == 0 for n in fed[:-1])
    if not native:
        assert len(fed) > 10
    assert got.amb.any().item() == amb
    assert (up.stats["elided_bytes"] > 0) == (not amb)


def test_ragged_chunk_before_the_last_raises_at_finish():
    data = _data(4 * 1024, False)
    up = dbgather.SeqDBUploader("cpu")
    up.feed(data[:1000])
    up.feed(data[1000:])
    with pytest.raises(ValueError, match="only the last chunk may be ragged"):
        up.finish()


def test_worker_error_raises_at_finish(monkeypatch):
    def broken(data, guard_bases=dbgather.GUARD_BASES):
        raise RuntimeError("pack failed")
    monkeypatch.setattr(dbgather, "pack_db_np", broken)
    up = dbgather.SeqDBUploader("cpu")
    up.feed(_data(2048, False))
    up.feed(_data(1024, False))
    with pytest.raises(RuntimeError, match="pack failed"):
        up.finish()
    with pytest.raises(RuntimeError, match="pack failed"):
        dbgather.upload_seqdb(_data(2048, False), "cpu")


# --- stage 1 takes the planes ----------------------------------------------

@pytest.fixture(scope="module")
def reads_lst(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    return lst


def _jax_index_files(lst: str, out: str, keep_l0: bool) -> str:
    """The JAX package's stage 0 and 1 on the manifest; with keep_l0 its
    level-0 index too (build_index(keep_l0=True), saved at level 0)."""
    asm = JaxAssembly(out, JaxConfig(**CFG))
    asm.build_db(reads_list=lst)
    asm.build_shimmer_index()
    if keep_l0:
        _, l0 = jindex.build_index(asm.db, JaxConfig(**CFG), keep_l0=True)
        l0.save(os.path.join(out, "1-index", "shmr"), level=0)
    return os.path.join(out, "1-index")


class _Planes:
    """Wraps Assembly._stage0_planes: keeps weak references to the planes
    it hands out and its log notes."""

    def __init__(self, monkeypatch):
        self.refs, self.notes = [], []
        orig = prun.Assembly._stage0_planes

        def wrapped(asm):
            packed, note = orig(asm)
            if packed is not None:
                self.refs += [weakref.ref(packed.fw), weakref.ref(packed.amb)]
                self.notes.append(note)
            return packed, note
        monkeypatch.setattr(prun.Assembly, "_stage0_planes", wrapped)

    def gone(self) -> bool:
        gc.collect()
        return all(r() is None for r in self.refs)


def _started(monkeypatch):
    """Stage 0 starts the uploader on the CPU device (the condition asks
    for a card)."""
    monkeypatch.setattr(prun, "_stage0_upload", lambda *a: True)


@pytest.mark.parametrize("keep_l0", [False, True], ids=["l2", "with_l0"])
def test_stage1_takes_the_uploaders_planes(reads_lst, tmp_path, monkeypatch,
                                           caplog, keep_l0):
    _started(monkeypatch)
    planes = _Planes(monkeypatch)
    with caplog.at_level(logging.INFO, logger="peregrine_tpu_torch"):
        asm = prun.Assembly(str(tmp_path / "wd"), AsmConfig(**CFG),
                            device="cpu")
        asm.build_db(reads_list=reads_lst)
        assert isinstance(asm._uploader, dbgather.SeqDBUploader)
        asm.build_shimmer_index(keep_l0=keep_l0)
    assert "seqdb upload to cpu started" in caplog.text
    assert "took the stage-0 seqdb planes: finish() waited" in caplog.text
    assert asm._uploader is None and len(planes.refs) == 2 and planes.gone()
    want = _jax_index_files(reads_lst, str(tmp_path / "jax"), keep_l0)
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(tmp_path / "wd" / "1-index")) == names
    assert any("L0" in n for n in names) == keep_l0
    for f in names:
        assert filecmp.cmp(str(tmp_path / "wd" / "1-index" / f),
                           os.path.join(want, f), shallow=False), f


def test_planes_dropped_before_the_segmented_build(reads_lst, tmp_path,
                                                   monkeypatch, caplog):
    """Under a small PG_HBM_DB_BUDGET stage 1 indexes in segments, with
    the uploader's planes freed before the first segment (the log says
    they were dropped), and writes the JAX package's files."""
    _started(monkeypatch)
    planes = _Planes(monkeypatch)
    monkeypatch.setenv("PG_HBM_DB_BUDGET", "100000")
    seg = prun.build_index_segmented
    seen = []

    def segmented(*a, **kw):
        seen.append(planes.gone())
        return seg(*a, **kw)
    monkeypatch.setattr(prun, "build_index_segmented", segmented)
    with caplog.at_level(logging.INFO, logger="peregrine_tpu_torch"):
        asm = prun.Assembly(str(tmp_path / "wd"), AsmConfig(**CFG),
                            device="cpu")
        asm.build_db(reads_list=reads_lst)
        asm.build_shimmer_index()
    assert "indexing in segments" in caplog.text
    assert "the stage-0 seqdb planes dropped" in caplog.text
    assert "took the stage-0" not in caplog.text
    assert seen == [True] and len(planes.refs) == 2
    want = _jax_index_files(reads_lst, str(tmp_path / "jax"), False)
    for f in os.listdir(want):
        assert filecmp.cmp(str(tmp_path / "wd" / "1-index" / f),
                           os.path.join(want, f), shallow=False), f


def test_planes_dropped_when_stage1_resumes(reads_lst, tmp_path, monkeypatch,
                                            caplog):
    """Stage 0 rebuilt over a finished stage 1: the index is loaded, the
    uploader is finished and its planes dropped."""
    _started(monkeypatch)
    out = str(tmp_path / "wd")
    first = prun.Assembly(out, AsmConfig(**CFG), device="cpu")
    first.build_db(reads_list=reads_lst)
    idx = first.build_shimmer_index()
    os.remove(os.path.join(out, "0-seqdb", "seq_dataset.idx"))
    planes = _Planes(monkeypatch)
    with caplog.at_level(logging.INFO, logger="peregrine_tpu_torch"):
        again = prun.Assembly(out, AsmConfig(**CFG), device="cpu")
        again.build_db(reads_list=reads_lst)
        got = again.build_shimmer_index()
    assert "stage 1 index" not in caplog.text
    assert again._uploader is None and len(planes.refs) == 2 and planes.gone()
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(idx, f))


@pytest.mark.parametrize("case", ["cpu", "card", "mesh", "over_budget"])
def test_start_condition_matches_jax(reads_lst, tmp_path, monkeypatch, case):
    """_stage0_upload against the JAX package's build_db (its backend
    patched to an accelerator's, or left on the CPU) on the same manifest:
    both start the uploader for a card with no mesh within the budget,
    and neither on the CPU, with a mesh, or past the budget."""
    est = prun._manifest_bytes(reads_lst)
    monkeypatch.setenv("PG_HBM_DB_BUDGET",
                       str(est - 1 if case == "over_budget" else est))
    mesh = case == "mesh"
    want = case == "card"
    if case != "cpu":
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    asm = JaxAssembly(str(tmp_path / "jax"), JaxConfig(**CFG, mesh=mesh))
    asm.build_db(reads_list=reads_lst)
    started = asm._seqdb_uploader is not None
    if started:
        asm._seqdb_uploader.finish()
    assert started == want
    device = torch.device("cpu" if case == "cpu" else "cuda")
    got = prun._stage0_upload(device, AsmConfig(**CFG, mesh=mesh),
                              make_mesh("cpu", 2 if mesh else 1), est)
    assert got == want
