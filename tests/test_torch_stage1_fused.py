"""The two fused kernels of stage 1's k <= 16 batch step against the JAX
package, on the CPU: gather_build_stream_plain against the JAX
gather_codes followed by the Pallas build_stream (interpret mode), and
reduce_drain_plain against the Pallas reduce_step and move_plane followed
by the JAX assemble_records and _compact_drain; then the step's launches
with the kernel library stubbed out (which C entries it calls, with which
arguments).

The same numpy inputs go to both packages.  Every value is an integer,
so the tolerance is exact equality.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from peregrine_tpu.ops import compact_pallas as pl
from peregrine_tpu.ops import dbgather as jdb
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.ops import sketch as jsketch
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import dbgather, index, kernels as kn
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

L = 4224  # windows past one 4,096-column chunk, a multiple of 128 (Pallas)


# --- gather_build_stream ---------------------------------------------------

@pytest.fixture(scope="module")
def fused_db():
    """fused_gather_seqs packed by both packages, the port's planes also
    as views cut to the data with junk after them, and the windows."""
    seqs = kernel_cases.fused_gather_seqs(L)
    db = SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=64)
    cut = dbgather.PackedSeqDB(fw=torch.from_numpy(fw)[:nf],
                               amb=torch.from_numpy(amb)[:na])
    goff, lens = kernel_cases.fused_gather_windows(db.offsets, db.lengths, L)
    return (dbgather.upload_seqdb(db.data, "cpu"), cut,
            jdb.upload_seqdb(db.data), goff, lens)


def test_fused_windows_cover_the_cases(fused_db):
    """Every residue of the gather start mod 32, lengths on and beside
    the chunk boundary, windows that run past the data's last base, and
    ambiguous runs across the boundary."""
    pdb, cut, _, goff, lens = fused_db
    assert set(goff[:32] % 32) == set(range(32))
    assert {0, 1, kn.CHUNK - 1, kn.CHUNK, kn.CHUNK + 1, L - 1, L} <= set(
        lens.tolist())
    codes = kn.gather_codes_plain(pdb, torch.from_numpy(goff),
                                  torch.from_numpy(lens), None, L, 4)
    inlen = torch.arange(L)[None, :] < torch.from_numpy(lens)[:, None]
    amb = (codes == 4) & inlen
    assert amb[:, kn.CHUNK - 1:kn.CHUNK + 1].all(1).sum() >= 8
    assert (goff + L > cut.fw.numel() * 4 - dbgather.GUARD_BASES).sum() >= 3


@pytest.mark.parametrize("k", [5, 16])
def test_gather_build_stream_plain_matches_jax(fused_db, k):
    """(H, P, n) of gather_build_stream_plain equal the Pallas
    build_stream's on the JAX gather_codes' windows (strand 0, fill 4),
    on padded planes and on planes cut to the data; dest equals the TPU
    kernel's shift distances (dest = col - r on kept entries), as
    test_torch_kernels.py compares them; and the wrapper takes the plain
    version on the CPU's planes."""
    pdb, cut, jpdb, goff, lens = fused_db
    jcodes = jdb.gather_codes(jpdb, jnp.asarray(goff), jnp.asarray(lens),
                              jnp.zeros(len(goff), jnp.int32), L, fill=4)
    H, P, r1, n = (np.asarray(a) for a in pl.build_stream(
        jcodes, jnp.asarray(lens.astype(np.int32)), k=k, interpret=True))
    col = np.arange(L)[None, :]
    for planes in (pdb, cut):
        tH, tP, dest, tn = kn.gather_build_stream_plain(
            planes, torch.from_numpy(goff), torch.from_numpy(lens), L, k)
        np.testing.assert_array_equal(tH.numpy().view(np.uint32), H)
        np.testing.assert_array_equal(tP.numpy().view(np.uint32), P)
        np.testing.assert_array_equal(tn.numpy(), n)
        kept = dest.numpy() >= 0
        np.testing.assert_array_equal(dest.numpy()[kept], (col - r1)[kept])
        np.testing.assert_array_equal(kept.sum(1), n)
        got = kn.gather_build_stream(planes, torch.from_numpy(goff),
                                     torch.from_numpy(lens), L, k=k)
        for a, b in zip(got, (tH, tP, dest, tn)):
            assert torch.equal(a, b)


def test_gather_build_stream_checks_its_inputs(fused_db):
    pdb, _, _, goff, lens = fused_db
    g, n = torch.from_numpy(goff), torch.from_numpy(lens)
    for kw in (dict(L=L, k=17), dict(L=L + 4, k=16),
               dict(L=dbgather.GUARD_BASES + 8, k=16)):
        with pytest.raises(ValueError):
            kn.gather_build_stream(pdb, g, n, **kw)
    with pytest.raises(ValueError):  # the metas are int64
        kn.gather_build_stream(pdb, g, n.int(), L, k=16)


# --- reduce_drain ----------------------------------------------------------

G, B, C, R = 3, 16, 640, 4  # batches, rows (a multiple of 8), columns, r
WIDTH = 40  # below many rows' counts


def _jax_level_stream(batches, k):
    """The JAX package's records: each batch's level (Pallas reduce_step
    and move_plane), its first WIDTH columns through assemble_records,
    then _compact_drain of all of them, cut to its valid count; and the
    levels' counts."""
    xs, ys, cs = [], [], []
    for H, P, n, _, rids in batches:
        H2, P2, rs, cnt = pl.reduce_step(jnp.asarray(H), jnp.asarray(P),
                                         jnp.asarray(n), r=R, interpret=True)
        oH = pl.move_plane(rs, H2, interpret=True)[:, :WIDTH]
        oP = pl.move_plane(rs, P2, interpret=True)[:, :WIDTH]
        x, y = jsketch.assemble_records(oH, oP, cnt,
                                        jnp.asarray(rids.astype(np.uint32)),
                                        k)
        xs.append(x)
        ys.append(y)
        cs.append(np.asarray(cnt))
    x, y, total = jindex._compact_drain(jnp.stack(xs), jnp.stack(ys),
                                        jnp.asarray(np.stack(cs)))
    total = int(total)
    return np.asarray(x)[:total], np.asarray(y)[:total], cs


def _drain_all(fn, batches, out, counts, cursor, **kw):
    for H, P, n, c0, rids in batches:
        fn(*(torch.from_numpy(a) for a in (H.view(np.int32), P.view(np.int32),
                                           n, rids, c0)),
           cursor, out, counts, r=R, k=16, width=WIDTH, **kw)


def test_reduce_drain_plain_matches_jax():
    """Three batches through one cursor: the stream equals the JAX
    package's level, assembled and drained, with rows of n = 0 and rows
    whose count exceeds the width; the count slots hold (c0, the level's
    count) a batch; the cursors moved past the records and the slots."""
    batches = kernel_cases.reduce_drain_batches(G, B, C, R, 256)
    want_x, want_y, cs = _jax_level_stream(batches, 16)
    total = len(want_x)
    assert any((c > WIDTH).any() for c in cs) and (batches[0][2] == 0).any()
    out = torch.full((total + 9, 2), 7, dtype=torch.int64)
    counts = torch.zeros((G + 1, 2, B + 2), dtype=torch.int32)
    cursor = torch.zeros(3, dtype=torch.int64)
    _drain_all(kn.reduce_drain, batches, out, counts, cursor)
    got = out.numpy().view(np.uint64)
    np.testing.assert_array_equal(got[:total, 0], want_x)
    np.testing.assert_array_equal(got[:total, 1], want_y)
    assert (out[total:] == 7).all()
    assert cursor.tolist() == [total, G, 0]
    for g, (_, _, _, c0, _) in enumerate(batches):
        np.testing.assert_array_equal(counts[g, 0, :B].numpy(), c0)
        np.testing.assert_array_equal(counts[g, 1, :B].numpy(), cs[g])
    assert not counts[G].any() and not counts[:, :, B:].any()


def test_reduce_drain_plain_is_the_level_then_the_drain():
    """The same three batches give the stream, slots and cursor that
    reduce_step_plain followed by drain_records_plain give, also into a
    stream that ends before the records."""
    batches = kernel_cases.reduce_drain_batches(G, B, C, R, 256)

    def level_then_drain(H, P, n, rids, c0, cursor, out, counts, *, r, k,
                         width):
        oH, oP, c = kn.reduce_step_plain(H, P, n, r)
        kn.drain_records_plain(oH, oP, rids, c, c0, cursor, out, counts, k=k,
                               width=width)

    for size in (2000, 150):
        runs = []
        for fn in (kn.reduce_drain_plain, level_then_drain):
            out = torch.full((size, 2), -3, dtype=torch.int64)
            counts = torch.full((G, 2, B), -5, dtype=torch.int32)
            cursor = torch.zeros(3, dtype=torch.int64)
            _drain_all(fn, batches, out, counts, cursor)
            runs.append((out, counts, cursor))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_reduce_drain_checks_its_inputs():
    H = torch.zeros((2, 12), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    rids = torch.zeros(2, dtype=torch.int64)
    cursor = torch.zeros(3, dtype=torch.int64)
    rec = torch.zeros((50, 2), dtype=torch.int64)
    for kw in (dict(r=1, width=10), dict(r=6, width=13)):
        with pytest.raises(ValueError):
            kn.reduce_drain(H, H, n, rids, n, cursor, rec, None, k=16, **kw)
    with pytest.raises(ValueError):  # int32 rids
        kn.reduce_drain(H, H, n, n, n, cursor, rec, None, r=6, k=16,
                        width=10)


# --- the step's launches, the library stubbed out ---------------------------

class _Launches:
    """The kernel library stubbed out on the CPU: each wrapper takes its
    CUDA branch and every C entry it calls is recorded with its arguments
    instead of launched."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kn, "_route", lambda *t: "cuda")
        monkeypatch.setattr(kn, "_status_pairs", {})
        monkeypatch.setattr(kn, "library", lambda: types.SimpleNamespace(**{
            name: name for name in kn.SIGNATURES}))
        monkeypatch.setattr(kn, "_call", lambda fn, *args:
                            self.calls.append((fn, args)))

    def names(self):
        return [fn for fn, _ in self.calls]


def _step(k, levels, keep_l0, rows=4, pad=4096):
    packed = dbgather.PackedSeqDB(fw=torch.zeros(8192, dtype=torch.uint8),
                                  amb=torch.zeros(4096, dtype=torch.uint8))
    cap = 0 if keep_l0 else 512
    step = index._Stage1Step(packed, torch.device("cpu"), pad, rows, cap,
                             keep_l0, dict(w=24, k=k, r=4, levels=levels), 2)
    step.metas.copy_(torch.tensor([[5, 900, 2000, 7], [800, 850, 1000, 3],
                                   [0, 1, 2, 3]]))
    return step


def test_step_at_k16_launches_the_fused_pair(monkeypatch):
    """At k=16 with two levels a batch is pg_gather_build_stream, the
    sketch's moves and emit_mask, level 1's pg_reduce_step and
    pg_reduce_drain, one each (no pg_gather_codes, pg_build_stream or
    pg_drain_records), with the arguments of their C prototypes
    (SIGNATURES, checked against the .cu file by test_torch_kernels.py):
    the planes and their byte counts, the metas' goff and lens rows as
    int64, the look-back status; level 1's outputs, the rids and the
    sketch count into the drain with the step's cursor, stream and count
    slots."""
    launches = _Launches(monkeypatch)
    step = _step(16, 2, False)
    before = {fn.__name__: fn.launches for fn in kn.KERNELS}
    step._body(4)
    assert launches.names() == ["pg_gather_build_stream", "pg_move_plane",
                                "pg_emit_mask", "pg_move_plane",
                                "pg_reduce_step", "pg_reduce_drain"]
    for fn, args in launches.calls:
        assert len(args) + 1 == len(kn.SIGNATURES[fn]), fn
    after = {fn.__name__: fn.launches for fn in kn.KERNELS}
    assert {n: after[n] - before[n] for n in after if after[n] > before[n]} \
        == {"gather_build_stream": 1, "move_plane": 2, "emit_mask": 1,
            "reduce_step": 1, "reduce_drain": 1}
    (_, g), (_, m1), (_, em), _, (_, red), (_, dr) = launches.calls
    fw, amb = step.packed.fw, step.packed.amb
    assert g[0] is fw and g[1] == fw.numel() and g[2] is amb
    assert g[3] == amb.numel()
    goff, lens = g[4], g[5]
    assert goff.dtype == lens.dtype == torch.int64
    assert goff.data_ptr() == step.metas[0].data_ptr()
    assert lens.data_ptr() == step.metas[1].data_ptr()
    assert g[6].numel() == kn.STATUS_SLOT * (1 + 4 * -(-4096 // kn.CHUNK))
    assert g[9:13] == (m1[1], m1[2], m1[0], em[2]) and g[13:] == (4, 4096, 16)
    # level 1 on the capped sketch; the drain on level 1's output
    assert red[9:] == (4, 512, 4)
    assert dr[:3] == red[6:9]
    assert dr[3].data_ptr() == step.metas[2].data_ptr()
    assert dr[8] is step.cursor and dr[9] is step.rec
    assert dr[10] is step.counts
    assert dr[6].numel() >= kn.STATUS_SLOT * (1 + 4)
    assert dr[11:] == (4, 512, 4, 16, step.out_w, step.rec.shape[0],
                       step.group, 4)


@pytest.mark.parametrize("k,levels,keep_l0,want", [
    (16, 0, False, ["pg_gather_build_stream", "pg_move_plane",
                    "pg_emit_mask", "pg_move_plane", "pg_drain_records"]),
    (16, 2, True, ["pg_gather_build_stream", "pg_move_plane",
                   "pg_emit_mask", "pg_move_plane", "pg_reduce_step",
                   "pg_reduce_drain", "pg_drain_records"]),
    (28, 2, False, ["pg_gather_codes", "pg_wide_stream", "pg_wide_emit",
                    "pg_compact_planes", "pg_reduce_wide",
                    "pg_reduce_wide_drain"]),
    (28, 2, True, ["pg_gather_codes", "pg_wide_stream", "pg_wide_emit",
                   "pg_compact_planes", "pg_reduce_wide",
                   "pg_reduce_wide_drain", "pg_drain_records"]),
    (28, 0, False, ["pg_gather_codes", "pg_wide_stream", "pg_wide_emit",
                    "pg_compact_planes", "pg_drain_records"]),
])
def test_step_keeps_the_standalone_kernels_elsewhere(monkeypatch, k, levels,
                                                     keep_l0, want):
    """With no level the step drains the sketch with pg_drain_records;
    the level-0 stream of keep_l0 drains alone; k=28 gathers with
    pg_gather_codes, and with a level its final level drains as
    pg_reduce_wide_drain.  At k=28 nothing copies the capped sketch:
    level 1 (or the drain of no level) reads the first `cap` columns of
    compact_planes' output in place, at its row stride, and takes its
    count c0 unclamped (the kernel clamps it)."""
    launches = _Launches(monkeypatch)
    step = _step(k, levels, keep_l0)
    step._body(4)
    assert launches.names() == want
    if keep_l0:  # the level-0 drain: the sketch's planes, uncapped
        fn, args = launches.calls[-1]
        assert args[5] is step.cursor0 and args[6] is step.rec0
        assert args[7] == 0 and args[9] == 4096
    if k > 16:
        calls = dict(launches.calls[:4])
        sx, sy = calls["pg_compact_planes"][7:9]
        c0 = calls["pg_compact_planes"][10]
        fn, args = launches.calls[4]
        cols = 4096 if keep_l0 else 512
        assert args[0].data_ptr() == sx.data_ptr()
        assert args[1].data_ptr() == sy.data_ptr()
        assert args[0].shape == (4, cols) and args[0].stride() == (4096, 1)
        if fn == "pg_reduce_wide":
            assert args[2] is c0 and args[9:12] == (4, cols, 4096)
        else:  # pg_drain_records of no level: the count clamped to the cap
            assert args[4] is c0 and args[8:11] == (4, cols, 4096)
            assert torch.equal(args[3], c0.clamp(max=cols))


def test_wide_step_fuses_the_final_level_and_the_drain(monkeypatch):
    """At k=28 with two levels a batch's final level is one
    pg_reduce_wide_drain launch on level 1's output, with the sketch
    count, the step's cursor, stream and count slots, the look-back
    status and the arguments of its C prototype."""
    launches = _Launches(monkeypatch)
    step = _step(28, 2, False)
    before = {fn.__name__: fn.launches for fn in kn.KERNELS}
    step._body(4)
    after = {fn.__name__: fn.launches for fn in kn.KERNELS}
    assert {n: after[n] - before[n] for n in after if after[n] > before[n]} \
        == {"gather_codes": 1, "wide_stream": 1, "wide_emit": 1,
            "compact_planes": 1, "reduce_wide": 1, "reduce_wide_drain": 1}
    for fn, args in launches.calls:
        assert len(args) + 1 == len(kn.SIGNATURES[fn]), fn
    (_, cp), (_, red), (_, dr) = launches.calls[3:]
    assert dr[:2] == red[6:8] and dr[2] is red[8] and dr[3] is cp[10]
    assert dr[4].numel() >= kn.STATUS_SLOT * (1 + 4)
    assert dr[7] is step.cursor and dr[8] is step.rec
    assert dr[9] is step.counts
    assert dr[10:] == (4, 512, 512, 4, step.out_w, step.rec.shape[0],
                       step.group, 4)
