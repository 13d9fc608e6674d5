"""Stage 1's batch step against the JAX package's, on the CPU: the plain
versions of the two kernels the step adds (gather_codes_plain against
the JAX gather_codes, drain_records_plain against the JAX _compact_drain
with assemble_records) and build_index as the step runs it, in fetch
groups with a retried batch in the middle of one, against the JAX
package's build_index.

The same numpy inputs go to both packages.  Every value is an integer,
so the tolerance is exact equality.  The shapes are small and shared by
the tests of each function.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import dbgather as jdb
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.ops import sketch as jsketch
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import dbgather, index, kernels as kn
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

L = 264  # windows: L % 16 == 8 leaves a half-filled last group of 16


# --- gather_codes ----------------------------------------------------------

@pytest.fixture(scope="module")
def gather_db():
    """torch_kernel_cases.gather_seqs packed by both packages; the port's
    planes also as views cut to the data with junk after them."""
    seqs = kernel_cases.gather_seqs()
    db = SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=64)
    cut = dbgather.PackedSeqDB(fw=torch.from_numpy(fw)[:nf],
                               amb=torch.from_numpy(amb)[:na])
    return (db, dbgather.upload_seqdb(db.data, "cpu"),
            jdb.upload_seqdb(db.data), cut)


@pytest.mark.parametrize("strand,fill", [(0, 4), (1, 4), (0, 7), (1, 7)])
def test_gather_codes_plain_matches_jax(gather_db, strand, fill):
    """Every residue of the gather start mod 16, lengths 0, 1, L - 1 and
    L, on padded planes and on planes cut to the data that are views into
    larger buffers (windows ending on the last base); strand 1 from a
    tensor of strands, strand 0 also as None."""
    db, pdb, jpdb, cut = gather_db
    goff, lens, st = kernel_cases.gather_windows(db.offsets, db.lengths,
                                                 strand, L)
    assert set(goff % 16) == set(range(16))
    assert {0, 1, L - 1, L} <= set(lens.tolist())
    want = np.asarray(jdb.gather_codes(jpdb, jnp.asarray(goff),
                                       jnp.asarray(lens), jnp.asarray(st), L,
                                       fill=fill))
    for planes in (pdb, cut):
        for strands in ((torch.from_numpy(st), None) if strand == 0
                        else (torch.from_numpy(st),)):
            got = dbgather.gather_codes_plain(
                planes, torch.from_numpy(goff), torch.from_numpy(lens),
                strands, L, fill)
            np.testing.assert_array_equal(got.numpy(), want)
            # the wrapper takes the plain version on the CPU's planes
            assert torch.equal(dbgather.gather_codes(
                planes, torch.from_numpy(goff), torch.from_numpy(lens),
                strands, L, fill), got)


# --- drain_records ---------------------------------------------------------

G, B, C = 3, 5, 40  # batches in one stream, rows, columns kept


def _jax_stream(batches, k):
    """The JAX package's records: assemble_records (k <= 16) of each
    batch, then _compact_drain of all of them, cut to its valid count."""
    xs, ys = [], []
    for a, b, c, _, rids in batches:
        a, b = a[:, :C], b[:, :C]
        if k <= 16:
            a, b = jsketch.assemble_records(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                jnp.asarray(rids.astype(np.uint32)), k)
        xs.append(jnp.asarray(a))
        ys.append(jnp.asarray(b))
    cs = jnp.asarray(np.stack([bt[2] for bt in batches]))
    x, y, n = jindex._compact_drain(jnp.stack(xs), jnp.stack(ys), cs)
    n = int(n)
    return np.asarray(x)[:n], np.asarray(y)[:n]


@pytest.mark.parametrize("k", [16, 28])
def test_drain_records_plain_matches_jax(k):
    """G batches through one cursor into one stream: the stream equals
    the JAX package's, the count slots hold (c0, count) a batch, and the
    cursor has moved past the records and the slots."""
    batches = kernel_cases.drain_batches(k, G, B, C)
    want_x, want_y = _jax_stream(batches, k)
    total = len(want_x)
    assert total == sum(np.minimum(bt[2], C).sum() for bt in batches)
    out = torch.full((total + 9, 2), 7, dtype=torch.int64)
    counts = torch.zeros((G + 1, 2, B + 2), dtype=torch.int32)
    cursor = torch.zeros(3, dtype=torch.int64)
    for a, b, c, c0, rids in batches:
        dt = np.int32 if k <= 16 else np.int64
        kn.drain_records(*(torch.from_numpy(p.view(dt)) for p in (a, b)),
                         torch.from_numpy(rids), torch.from_numpy(c),
                         torch.from_numpy(c0), cursor, out, counts, k=k,
                         width=C)
    got = out.numpy().view(np.uint64)
    np.testing.assert_array_equal(got[:total, 0], want_x)
    np.testing.assert_array_equal(got[:total, 1], want_y)
    assert (out[total:] == 7).all()
    assert cursor.tolist() == [total, G, 0]
    for g, (_, _, c, c0, _) in enumerate(batches):
        np.testing.assert_array_equal(counts[g, 0, :B].numpy(), c0)
        np.testing.assert_array_equal(counts[g, 1, :B].numpy(), c)
    assert not counts[G].any() and not counts[:, :, B:].any()


def test_drain_records_plain_stops_at_the_stream_end():
    """A stream shorter than the records keeps the ones that fit; the
    cursor still counts them all (the caller's check sees the excess)."""
    a, b, c, c0, rids = kernel_cases.drain_batches(16, G, B, C)[0]
    n = int(np.minimum(c, C).sum())
    out = torch.zeros((n - 5, 2), dtype=torch.int64)
    full = torch.zeros((n, 2), dtype=torch.int64)
    for stream in (out, full):
        cursor = torch.zeros(3, dtype=torch.int64)
        kn.drain_records_plain(torch.from_numpy(a.view(np.int32)),
                               torch.from_numpy(b.view(np.int32)),
                               torch.from_numpy(rids), torch.from_numpy(c),
                               torch.from_numpy(c0), cursor, stream, None,
                               k=16, width=C)
        assert cursor.tolist() == [n, 1, 0]
    assert torch.equal(out, full[:n - 5])


# --- build_index -----------------------------------------------------------

@pytest.fixture(scope="module")
def stage1_reads():
    return kernel_cases.stage1_reads()


@pytest.mark.parametrize("k,w,keep_l0", [(16, 24, False), (16, 24, True),
                                         (28, 8, False), (28, 24, True)])
def test_build_index_in_fetch_groups_matches_jax(stage1_reads, monkeypatch,
                                                 k, w, keep_l0):
    """Batches of four in fetch groups of three (so the 2048 bucket's four
    batches take two groups), the two buckets, the level-0 index, and at
    k=28, w=8 the second batch of the first group overflowing its cap and
    retried exactly: byte for byte the JAX package's build_index."""
    monkeypatch.setattr(index, "FETCH_GROUP", 3)
    cfg = dict(k=k, w=w, r=4, levels=2, sketch_pad_len=8192, sketch_batch=4)
    jout = jindex.build_index(JaxSeqDB.from_reads(stage1_reads),
                              JaxConfig(**cfg), keep_l0=keep_l0)
    index.reset_stats()
    tout = index.build_index(SeqDB.from_reads(stage1_reads),
                             AsmConfig(**cfg), "cpu", keep_l0=keep_l0)
    pairs = zip(jout, tout) if keep_l0 else [(jout, tout)]
    for j, t in pairs:
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                          err_msg=f)
    # 2048 bucket: 4 batches in groups of 3 + 1; 4096 bucket: 2 batches
    assert index.STATS["group_fetches"] == 3
    # w=8: the 2048 bucket's second batch (of the first group) and both of
    # the 4096 bucket's (sketches of ~670 past its cap of 512)
    assert index.STATS["retried_batches"] == (3 if w == 8 else 0)
    assert index.STATS["replays"] == 0  # the CPU runs the step eagerly


def test_wrappers_launch_with_the_c_arguments(monkeypatch):
    """With the kernel library stubbed out on the CPU, gather_codes and
    drain_records take their CUDA branch: one launch each, counted, with
    the arguments of their C prototypes (SIGNATURES, checked against the
    .cu file by test_torch_kernels.py): the planes' byte counts, goff
    and lens as int64, no strand as a null pointer; the drain's row
    stride, element bytes and stream and slot sizes."""
    calls = []
    monkeypatch.setattr(kn, "_route", lambda *t: "cuda")
    monkeypatch.setattr(kn, "library", lambda: type("Lib", (), {
        name: name for name in kn.SIGNATURES}))
    monkeypatch.setattr(kn, "_call", lambda fn, *args:
                        calls.append((fn, args)))
    fw = torch.zeros(4096, dtype=torch.uint8)
    amb = torch.zeros(2048, dtype=torch.uint8)
    pdb = dbgather.PackedSeqDB(fw=fw, amb=amb)
    goff = torch.tensor([3, -5], dtype=torch.int32)
    lens = torch.tensor([9, 0], dtype=torch.int32)
    before = [fn.launches for fn in kn.KERNELS]
    out = dbgather.gather_codes(pdb, goff, lens, None, 16, fill=4)
    [(fn, args)] = calls
    assert fn == "pg_gather_codes" and len(args) + 1 == len(kn.SIGNATURES[fn])
    assert args[0] is fw and args[1] == 4096 and args[2] is amb
    assert args[3] == 2048 and args[6] == 0 and args[7] is out
    assert args[4].dtype == args[5].dtype == torch.int64
    assert args[4].tolist() == [3, -5] and args[5].tolist() == [9, 0]
    assert args[8:] == (2, 16, 4) and out.shape == (2, 16)

    calls.clear()
    H = torch.zeros((2, 12), dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int32)
    rids = torch.zeros(2, dtype=torch.int64)
    cursor = torch.zeros(3, dtype=torch.int64)
    rec = torch.zeros((50, 2), dtype=torch.int64)
    counts = torch.zeros((4, 2, 3), dtype=torch.int32)
    kn.drain_records(H, H.clone(), rids, c, c, cursor, rec, counts, k=16,
                     width=10)
    [(fn, args)] = calls
    assert fn == "pg_drain_records" and len(args) + 1 == len(kn.SIGNATURES[fn])
    assert args[0] is H and args[2] is rids and args[5] is cursor
    assert args[6] is rec and args[7] is counts
    assert args[8:] == (2, 10, 12, 4, 16, 50, 4, 3)
    calls.clear()
    x = torch.zeros((2, 12), dtype=torch.int64)
    kn.drain_records(x, x.clone(), None, c, c, cursor, rec, None, k=28,
                     width=12)
    [(fn, args)] = calls
    assert args[2] == 0 and args[7] == 0 and args[8:] == (2, 12, 12, 8, 28,
                                                          50, 0, 0)
    after = [fn.launches for fn in kn.KERNELS]
    assert [a - b for a, b in zip(after, before)] == [0] * 8 + [1, 2, 0, 0,
                                                            0]
    with pytest.raises(ValueError):  # past the planes' width
        kn.drain_records(x, x, None, c, c, cursor, rec, None, k=28, width=13)
