"""The port's mesh paths on in-process CPU meshes, against the JAX
package's on its 8 virtual CPU devices (tests/conftest.py).

Shapes of the reference's tests/test_sharded.py and
tests/test_sharded_pairs.py.  Everything is held to exact equality:
sharded_index_host shard by shard at 8 shards (k=12, and k=28 where
x = hash << 8 | span sets bit 63 on about half the records and only the
x ^ 2^63 order sorts them); build_index_mesh against build_index and the
JAX build_index_mesh, with a 20 kb sequence on the long route and on the
mesh's batch route; build_pairs_mesh at 2, 4 and 8 shards against the
host build and the JAX build_pairs_mesh; shard_seqdb's cuts and
sharded_align against the JAX package's and against myers_batch_db;
overlap_chunk_device with shard_overlap against the unsharded call; and
Assembly over an 8-shard mesh, and the three flags through the CLI.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.parallel import sharded_index as jax_si
from peregrine_tpu.parallel import sharded_overlap as jax_so
from peregrine_tpu.parallel.sharded_pairs import build_pairs_mesh as jax_bpm
from peregrine_tpu.pipeline.run import Assembly as JaxAssembly
from peregrine_tpu_torch import cli
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops.dbgather import upload_seqdb
from peregrine_tpu_torch.ops.device_align import myers_batch_db
from peregrine_tpu_torch.ops.index import ShimmerIndex, _merge_counts, build_index
from peregrine_tpu_torch.ops import overlap as overlap_mod
from peregrine_tpu_torch.ops.overlap import (bucket_stream, build_pairs,
                                             overlap_chunk_device,
                                             ovlps_to_text)
from peregrine_tpu_torch.parallel import distributed
from peregrine_tpu_torch.parallel import sharded_index as si
from peregrine_tpu_torch.parallel import sharded_overlap as so
from peregrine_tpu_torch.parallel.mesh import Mesh, exchange, make_mesh
from peregrine_tpu_torch.parallel.sharded_pairs import build_pairs_mesh
from peregrine_tpu_torch.pipeline import run as pipeline_run
from peregrine_tpu_torch.pipeline.run import Assembly
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

K12 = dict(k=12, w=24, r=4, levels=2)


def _reads(seed, genome_len, read_len, coverage, **kw):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    reads, _ = simulate_reads(rng, genome, read_len=read_len,
                              coverage=coverage, **kw)
    return genome, reads


def _same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f"{what}[{i}] dtype {x.dtype} {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}[{i}]")


def test_jax_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_cpu():
    assert make_mesh("cpu").n == 1
    m = make_mesh("cpu", 8)
    assert (m.n, m.local, m.group) == (8, list(range(8)), None)
    assert all(d == torch.device("cpu") for d in m.devices)


def test_collectives_in_process():
    """all_to_all transposes [n, cap] rows; all_gather returns every
    shard's tensor; exchange delivers each record to its target in
    source order, an empty exchange included."""
    m = make_mesh("cpu", 3)
    sends = [torch.arange(6).view(3, 2) + 10 * s for s in range(3)]
    recv = m.all_to_all(sends)
    for d in range(3):
        for s in range(3):
            assert recv[d][s].tolist() == sends[s][d].tolist()
    parts = [torch.arange(s) for s in range(3)]
    assert [g.tolist() for g in m.all_gather(parts)] == [[], [0], [0, 1]]
    targets = [torch.tensor([2, 0, 2]), torch.tensor([1]),
               torch.tensor([], dtype=torch.int64)]
    recs = [torch.tensor([[1], [2], [3]]), torch.tensor([[4]]),
            torch.zeros((0, 1), dtype=torch.int64)]
    got = exchange(m, targets, recs)
    assert [g[:, 0].tolist() for g in got] == [[2], [4], [1, 3]]
    none = exchange(m, [t[:0] for t in targets], [r[:0] for r in recs])
    assert [g.shape for g in none] == [(0, 1)] * 3


@pytest.fixture(scope="module")
def batch_db():
    """test_sharded.py's set: a 30 kb genome, 3 kb reads, 8x."""
    _, reads = _reads(42, 30000, 3000, 8.0)
    return SeqDB.from_reads(reads)


# (k, w, levels, read length, pad): test_sharded.py's k=12 and k=28
# steps, and a k=28 sketch at w=2 of 300 b reads, whose minimizers are
# minima of two hashes, so a quarter reach 2^55 and set bit 63 of x
STEPS = {"k12": (12, 24, 2, 3000, 8192), "k28": (28, 24, 2, 3000, 8192),
         "k28-high": (28, 2, 0, 300, 4096)}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_sharded_index_host_matches_jax(case):
    k, w, levels, read_len, pad = STEPS[case]
    _, reads = _reads(42, 30000, read_len, 8.0, len_sd=read_len // 10)
    db = SeqDB.from_reads(reads)
    codes, lens = db.padded_code_batch(range(len(db)), pad)
    rids = np.arange(len(db), dtype=np.uint32)
    step = dict(w=w, k=k, r=4, levels=levels)
    got = si.sharded_index_host(make_mesh("cpu", 8), codes, lens, rids,
                                **step)
    want = jax_si.sharded_index_host(jax_si.make_mesh(8), codes, lens, rids,
                                     **step)
    assert len(got) == 8
    for d, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        _same((gx, gy), (wx, wy), f"shard {d}")
        assert ((gx >> np.uint64(8)) % np.uint64(8) == d).all()
    x = np.concatenate([sx for sx, _ in got])
    ref = build_index(db, AsmConfig(sketch_pad_len=pad, sketch_batch=64,
                                    **step), "cpu")
    assert sorted(zip(x.tolist(), np.concatenate(
        [sy for _, sy in got]).tolist())) == sorted(
        zip(ref.x.tolist(), ref.y.tolist()))
    if case == "k28-high":
        assert 0.1 < (x >> np.uint64(63)).mean() < 0.5


@pytest.mark.parametrize("pad", [8192, 16384])
def test_build_index_mesh_matches_build_index_and_jax(pad):
    """A 20 kb sequence: past 2 * pad = 16384 it takes the long route
    (_index_long); at pad 16384 the mesh build batches it (L=20480) where
    build_index takes the long route.  Its records are the same."""
    genome, reads = _reads(42, 40000, 3000, 10.0)
    reads.append(("long", genome[:20000]))
    cfg = AsmConfig(sketch_pad_len=pad, sketch_batch=16, **K12)
    db = SeqDB.from_reads(reads)
    got = si.build_index_mesh(db, cfg, make_mesh("cpu", 8))
    want = build_index(db, cfg, "cpu")
    jcfg = JaxConfig(sketch_pad_len=pad, sketch_batch=16, **K12)
    jwant = jax_si.build_index_mesh(db, jcfg, mesh=jax_si.make_mesh(8))
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(jwant, f))


def test_sketch_cap_overflow_raises(batch_db):
    """At w=8 the density 2/9 passes the cap of L/8 columns: the mesh
    build raises instead of truncating, as the reference does."""
    cfg = AsmConfig(k=12, w=8, r=4, levels=2, sketch_pad_len=8192)
    with pytest.raises(ValueError, match="sketch cap overflowed"):
        si.build_index_mesh(batch_db, cfg, make_mesh("cpu", 2))


def _high(idx: ShimmerIndex) -> ShimmerIndex:
    """The same records with every hash moved to [2^55, 2^56) by a
    bijection, so the pairs stay and x uses all 64 bits."""
    h = (idx.x >> np.uint64(8)) ^ np.uint64((1 << 55) | 0x5A5A5A5A5A5A)
    x = (h << np.uint64(8)) | (idx.x & np.uint64(0xFF))
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, idx.y.copy(), mh, mc)


@pytest.fixture(scope="module")
def pair_indexes():
    """test_sharded_pairs.py's set (40 kb genome, 3 kb reads, 12x) at k=12,
    and at k=28 with hashes at or above 2^55."""
    _, reads = _reads(42, 40000, 3000, 12.0)
    db = SeqDB.from_reads(reads)
    out = {}
    for k in (12, 28):
        out[k] = build_index(db, AsmConfig(
            k=k, w=24, r=4, levels=2, sketch_pad_len=8192, sketch_batch=16),
            "cpu")
    out[28] = _high(out[28])
    return db, out


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("k", [12, 28])
def test_build_pairs_mesh_matches_host_and_jax(pair_indexes, k, n):
    db, idx = pair_indexes
    idx = idx[k]
    gates = (2, 240, 100, 120)
    pairs, stream = build_pairs_mesh(idx, db.lengths, make_mesh("cpu", n),
                                     *gates)
    hp = build_pairs(idx, db.lengths, 1, 1, *gates[:3])
    hs = bucket_stream(hp[0], hp[1], hp[2], hp[4], gates[3])
    assert len(hp[0]) > 0 and len(hs[0]) > 0
    _same(pairs, hp, "pairs")
    _same(stream, hs, "stream")
    jp, js = jax_bpm(idx, db.lengths, jax_si.make_mesh(n), *gates)
    for i, (a, b) in enumerate(zip(pairs + stream, jp + js)):
        np.testing.assert_array_equal(a, b, err_msg=f"vs JAX [{i}]")


@pytest.mark.parametrize("gather_lanes", [None, 7])
def test_sharded_align_matches_jax_and_one_device(rng, monkeypatch,
                                                  gather_lanes):
    """test_sharded.py's 100 random requests over 8 shards, with windows
    of L=4096 (every read fits; sharded_align refuses a longer one);
    gathered in one piece, and in pieces of 7 lanes."""
    if gather_lanes:
        monkeypatch.setattr(so, "GATHER_BYTES",
                            gather_lanes * so.GATHER_BYTES_PER_BASE * 4096)
        assert so.gather_lanes(4096) == gather_lanes
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=1500, coverage=12.0,
                              circular_wrap=2000)
    db = SeqDB.from_reads(reads)
    sdb = so.shard_seqdb(db.data, db.offsets, db.lengths, make_mesh("cpu", 8))
    jsdb = jax_so.shard_seqdb(db.data, db.offsets, db.lengths,
                              jax_si.make_mesh(8))
    np.testing.assert_array_equal(sdb.owner, jsdb.owner)
    np.testing.assert_array_equal(sdb.base, jsdb.base)
    nreq, L = 100, 4096
    q_rid = rng.integers(0, len(db), nreq)
    t_rid = rng.integers(0, len(db), nreq)
    q_shift = rng.integers(0, 200, nreq)
    q_off = db.offsets[q_rid] + q_shift
    q_len = (db.lengths[q_rid] - q_shift).astype(np.int32)
    t_off = db.offsets[t_rid]
    t_len = db.lengths[t_rid].astype(np.int32)
    q_strand = rng.integers(0, 2, nreq).astype(np.int32)
    t_strand = rng.integers(0, 2, nreq).astype(np.int32)
    req = (q_rid, q_off, q_len, q_strand, t_rid, t_off, t_len, t_strand)
    got = so.sharded_align(sdb, *req, L=L)
    want = jax_so.sharded_align(jsdb, *req, L=L, nb=8, unroll=1)
    cols = np.stack([q_off, db.offsets[q_rid], q_len, q_strand, t_off,
                     t_len, t_strand], 1).astype(np.int64)
    one = myers_batch_db(upload_seqdb(db.data, "cpu"), torch.from_numpy(cols))
    for g, w, o in zip(got, want, one):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, o.numpy())
    with pytest.raises(ValueError, match="longer than L"):
        so.sharded_align(sdb, *req, L=1024)


def test_pack2_matches_jax():
    codes = np.random.default_rng(3).integers(0, 8, (5, 64)).astype(np.uint8)
    got = so._pack2(torch.from_numpy(codes))
    want = jax_so._pack2(jax.numpy.asarray(codes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lanes_a_call", [None, 37])
def test_overlap_chunk_device_sharded_matches_unsharded(monkeypatch,
                                                        lanes_a_call):
    """At 2 shards, with the default budget (one sharded_align call a
    length class here) and with one of 37 lanes a call at L = 8 kb."""
    cfg = AsmConfig(min_len=2500, min_ovlp_aln=500, sketch_pad_len=8192,
                    sketch_batch=16, use_device_aligner=True, **K12)
    _, reads = _reads(42, 20000, 3000, 12.0, circular_wrap=4000)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg, "cpu")
    single = ovlps_to_text(overlap_chunk_device(db, idx, cfg, "cpu"))
    if lanes_a_call:
        monkeypatch.setattr(
            overlap_mod, "SHARDED_ALIGN_BYTES",
            lanes_a_call * overlap_mod.SHARDED_ALIGN_BYTES_PER_BASE * 8192)
    sizes = []
    align = so.sharded_align

    def spy(sdb, *req, L):
        sizes.append((L, len(req[0])))
        return align(sdb, *req, L=L)

    monkeypatch.setattr(so, "sharded_align", spy)
    sharded = ovlps_to_text(overlap_chunk_device(
        db, idx, cfg.replace(shard_overlap=True), "cpu",
        mesh=make_mesh("cpu", 2)))
    assert single == sharded
    assert len(single) > 50
    assert {L for L, _ in sizes} == {8192}
    if lanes_a_call:
        assert max(n for _, n in sizes) == lanes_a_call < sum(
            n for _, n in sizes)
    else:
        assert len(sizes) == 1


def test_mesh_assembly_matches_jax(tmp_path):
    """test_sharded.py:171's run: stages 0-3 with cfg.mesh over 8 CPU
    shards equal the JAX package's mesh run, file by file."""
    _, reads = _reads(42, 30000, 3000, 10.0)
    kw = dict(min_len=2000, sketch_pad_len=8192, sketch_batch=16, mesh=True,
              **K12)
    mesh = make_mesh("cpu", 8)
    fa = Assembly(str(tmp_path / "port"), AsmConfig(**kw), device="cpu",
                  mesh=mesh).run_draft(reads=reads)
    jfa = JaxAssembly(str(tmp_path / "jax"), JaxConfig(**kw)).run_draft(
        reads=reads)
    for rel in ("1-index/shmr-L2-01-of-01.dat",
                "1-index/shmr-L2-MC-01-of-01.dat", "2-ovlp/preads.ovl",
                "3-asm/p_ctg.fa"):
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel,
                           shallow=False), rel
    assert os.path.getsize(fa) == os.path.getsize(jfa) > 20000


FLAG_SHAPE = ["--shimmer-k", "12", "--shimmer-w", "24", "--shimmer-r", "4",
              "--min_len", "2000", "--device", "cpu"]


@pytest.fixture(scope="module")
def flag_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("flags")
    _, reads = _reads(42, 30000, 3000, 10.0)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    return d, lst


@pytest.mark.parametrize("flag,path", [
    ("--mesh", (si, "build_index_mesh")),
    ("--shard-overlap", (so, "sharded_align")),
    ("--multihost", (Assembly, "run_multihost")),
])
def test_flag_reaches_its_path(flag_reads, tmp_path, monkeypatch, flag, path):
    """Each flag on --device cpu, over a mesh of two CPU shards (the
    cpu device alone makes a mesh of one), reaches its path and writes
    the single-device run's preads.ovl and p_ctg.fa.  --shard-overlap
    implies --device-aligner, through overlap_chunk_device: its baseline
    is the same flag on the one-shard mesh, which aligns unsharded."""
    d, lst = flag_reads
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    base = str(tmp_path / "base")
    baseline = [flag] if flag == "--shard-overlap" else []
    assert cli.main(["asm", lst, "--output", base] + baseline
                    + FLAG_SHAPE) == 0
    # Assembly's mesh, and run_multihost's global mesh without a group
    for owner in (pipeline_run, distributed):
        monkeypatch.setattr(owner, "make_mesh",
                            lambda device: Mesh([device] * 2))
    calls = []
    owner, name = path
    fn = getattr(owner, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(owner, name, spy)
    shards = []
    index_mesh = si.build_index_mesh

    def spy_index(db, cfg, mesh, *a, **kw):
        shards.append(mesh.n)
        return index_mesh(db, cfg, mesh, *a, **kw)

    if flag != "--mesh":
        monkeypatch.setattr(si, "build_index_mesh", spy_index)
    out = str(tmp_path / "flag")
    assert cli.main(["asm", lst, "--output", out, flag] + FLAG_SHAPE) == 0
    assert calls, f"{flag} did not reach {name}"
    if flag == "--multihost":
        assert shards == [2], "run_multihost's mesh is not the two shards"
    for rel in ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa"):
        assert filecmp.cmp(os.path.join(base, rel), os.path.join(out, rel),
                           shallow=False), rel
