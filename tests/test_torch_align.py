"""The port's banded Myers aligner (plain PyTorch, the CPU route) against
the JAX package's device aligner on the CPU, lane for lane.

Same numpy inputs from a seed go to both: the crafted requests of
torch_kernel_cases.myers_lanes (identical sequences, a query shorter
than its target and the reverse, q_len < 32, a t_len not a multiple of
32, 10% error, tandem repeats at the ends, ambiguous bases, a lane at
aln_max_len, a query window inside its read, empty and one-base
sequences, windows starting at every residue mod 16 with t_len of 16m +- 1
and 32m +- 1, strand-1 windows down to the first base after the guard,
and windows that end on the data's last base, each on all four strand
pairs) and random overlap requests.
Every output is an integer, so the tolerance is exact equality.  The JAX
aligner runs at unroll=1, as its own CPU tests run it.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import device_align as jda
from peregrine_tpu.ops.dbgather import upload_seqdb as jax_upload
from peregrine_tpu_torch.io.seqdb import SeqDB, revcomp, seq_to_codes
from peregrine_tpu_torch.ops import dbgather
from peregrine_tpu_torch.ops import device_align as da
from peregrine_tpu_torch.simdata import mutate, random_genome
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

READ_LEN, CAP = 1500, 4096


def _db(seqs):
    return SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)])


def _jax_db_lanes(seqs, cols, L):
    """JAX myers_batch_db at pad length L (the pipeline's 8 kb classes)."""
    jdb = jax_upload(JaxSeqDB.from_reads(
        [(str(i), s) for i, s in enumerate(seqs)]).data)
    args = [jnp.asarray(cols[:, i] if i in (0, 1, 4)
                        else cols[:, i].astype(np.int32)) for i in range(7)]
    return [np.asarray(a) for a in jda.myers_batch_db(jdb, *args, L=L, nb=8,
                                                      unroll=1)]


def _padded_codes(seqs):
    codes = [seq_to_codes(s) for s in seqs]
    L = max(1, max(len(c) for c in codes))
    out = np.full((len(codes), L), 7, np.uint8)
    for i, c in enumerate(codes):
        out[i, :len(c)] = c
    return out, np.array([len(c) for c in codes], np.int32)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(11)
    return {"crafted": kernel_cases.myers_lanes(rng, READ_LEN, CAP),
            "random": kernel_cases.myers_requests(rng, 48, 2000, 300, 0.01)}


_JAX_LANES = {}


def _jax_lanes(lanes, kind):
    """JAX myers_batch_db of a kind's lanes at the 8 kb pad class, once."""
    if kind not in _JAX_LANES:
        seqs, cols = lanes[kind]
        assert max(cols[:, 2].max(), cols[:, 5].max()) <= 8192
        _JAX_LANES[kind] = _jax_db_lanes(seqs, cols, 8192)
    return _JAX_LANES[kind]


@pytest.mark.parametrize("kind", ["crafted", "random"])
def test_myers_batch_db_matches_jax(lanes, kind):
    """myers_batch_db on CPU tensors (gather_codes + myers_core_plain) is
    the JAX myers_batch_db lane for lane, though the JAX package pads to
    8 kb classes and the port to the longest lane."""
    seqs, cols = lanes[kind]
    before = da.myers_batch_db.launches
    got = da.myers_batch_db(dbgather.upload_seqdb(_db(seqs).data, "cpu"),
                            torch.from_numpy(cols))
    want = _jax_lanes(lanes, kind)
    for name, g, w in zip(("dist", "q_end", "t_end"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert da.myers_batch_db.launches == before   # the plain route


def test_crafted_lanes_reach_every_word_boundary(lanes):
    """The crafted lanes start query and target reads at every residue
    mod 16 on all four strand pairs, hold t_len of 16m +- 1 and 32m +- 1,
    read strand 1 down to the first base after the guard, and end
    queries and targets of both strands on the data's last base, whose
    count is a multiple of 8 (so planes cut to the data end there)."""
    seqs, cols = lanes["crafted"]
    n = sum(len(s) for s in seqs)
    assert n % 8 == 0
    q_off, rs, q_len, qs, t_off, t_len, ts = cols.T
    q_lo = np.where(qs == 0, q_off, rs)
    for s in range(2):
        for s2 in range(2):
            pair = (qs == s) & (ts == s2)
            assert set(q_lo[pair] % 16) == set(range(16))
            assert set(t_off[pair] % 16) == set(range(16))
            # strand 1 reads its window from the top down to q_lo, t_off
            assert ((q_lo[pair] == 0) & (q_len[pair] > 0)).any() or s == 0
            assert ((t_off[pair] == 0) & (t_len[pair] > 1)).any() or s2 == 0
            assert (np.where(qs == 0, q_off, rs)[pair] + q_len[pair]
                    == n).any()
            assert (t_off[pair] + t_len[pair] == n).any()
            # t_len of 32m - 1, 32m + 1, 16(2m + 1) - 1 and 16(2m + 1) + 1
            assert {1, 15, 17, 31} <= set(t_len[pair & (t_len > 32)] % 32)


def test_plane_end_lanes_match_jax(lanes):
    """The crafted lanes on planes cut to the data, so that the last
    lanes end on the planes' last base, with junk after the planes that
    gather_codes must never read (numpy views into larger buffers), give
    the JAX package's results on its padded planes."""
    seqs, cols = lanes["crafted"]
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=64)
    pdb = dbgather.PackedSeqDB(fw=torch.from_numpy(fw)[:nf],
                               amb=torch.from_numpy(amb)[:na])
    got = da.myers_batch_db(pdb, torch.from_numpy(cols))
    for name, g, w in zip(("dist", "q_end", "t_end"), got,
                          _jax_lanes(lanes, "crafted")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_past_end_lanes_clamp_to_the_last_byte(lanes):
    """Windows that run past the planes' end read the last byte again, as
    gather_codes' clamp (and the kernel) does, whatever follows the
    planes: the past-end lanes give the same results over two kinds of
    junk."""
    seqs, _ = lanes["crafted"]
    n = sum(len(s) for s in seqs)
    cols = torch.from_numpy(kernel_cases.myers_past_end_lanes(seqs))
    assert (cols[:, 4] + cols[:, 5] > n).all()
    outs = []
    for seed in (1, 2):
        fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=64,
                                                        seed=seed)
        pdb = dbgather.PackedSeqDB(fw=torch.from_numpy(fw)[:nf],
                                   amb=torch.from_numpy(amb)[:na])
        one = torch.ones(1, dtype=torch.int64)
        codes = dbgather.gather_codes(pdb, one * (n - 8), one * 40, one * 0,
                                      40, fill=7)[0].tolist()
        assert codes[8:] == [(int(fw[nf - 1]) >> 2 * ((n + i) % 4)) & 3
                             for i in range(32)]
        outs.append(da.myers_batch_db(pdb, cols))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _views(seqs, cols):
    """Each lane's query and target as the aligner sees them."""
    data = b"".join(seqs)
    out = []
    for q_off, rs, ql, qs, t_off, tl, ts in cols.tolist():
        q = (data[q_off:q_off + ql] if qs == 0
             else revcomp(data[rs:rs + ql]))
        t = data[t_off:t_off + tl]
        t = t if ts == 0 else revcomp(t)
        out.append((q, t))
    return out


@pytest.mark.parametrize("kind", ["crafted", "random"])
def test_myers_core_plain_matches_jax(lanes, kind):
    """myers_core_plain on padded code arrays equals JAX myers_batch."""
    views = _views(*lanes[kind])
    qc, ql = _padded_codes([q for q, _ in views])
    tc, tl = _padded_codes([t for _, t in views])
    got = da.myers_core_plain(torch.from_numpy(qc), torch.from_numpy(ql),
                              torch.from_numpy(tc), torch.from_numpy(tl))
    want = jda.myers_batch(jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(tc),
                           jnp.asarray(tl), nb=8, unroll=1)
    for name, g, w in zip(("dist", "q_end", "t_end"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_strand_views_align_alike(lanes):
    """The crafted kinds show the aligner the same query and target on
    all four strand pairs, so the strand-1 reads of the fused gather must
    give the same (dist, q_end, t_end) on each."""
    seqs, cols = lanes["crafted"]
    got = da.myers_batch_db(dbgather.upload_seqdb(_db(seqs).data, "cpu"),
                            torch.from_numpy(cols))
    res = np.stack([g.numpy() for g in got], 1).reshape(-1, 4, 3)
    assert (res == res[:, :1]).all()
    d, qe, te = got
    assert (d[0], qe[0], te[0]) == (0, READ_LEN, READ_LEN)


def test_myers_batch_np_matches_jax():
    rng = np.random.default_rng(5)
    qs, ts = [], []
    for n in (40, 700, 1300, 1):
        a = random_genome(rng, n)
        qs.append(seq_to_codes(a))
        ts.append(seq_to_codes(mutate(rng, a, 0.03)))
    qs.append(seq_to_codes(b"ACGTNACGT" * 30))
    ts.append(seq_to_codes(b"ACGTAACGT" * 31))
    got = da.myers_batch_np(qs, ts, device="cpu")
    assert got == jda.myers_batch_np(qs, ts, unroll=1)


def test_binding_matches_c_prototype():
    """The extern "C" entry of myers_align.cu and its ctypes signature
    agree in count and kinds, and the kernel's window and guard are the
    module's NB and dbgather's GUARD_BASES."""
    with open(da._CU) as f:
        src = f.read()
    block = src.split('extern "C" {')[1]
    protos = re.findall(r"^int (pg_\w+)\(([^)]*)\)", block, re.M)
    assert [name for name, _ in protos] == list(da.SIGNATURES)
    for name, params in protos:
        kinds = [ctypes.c_void_p if "*" in p
                 else ctypes.c_longlong if "long long" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == da.SIGNATURES[name], name
        assert [p.split()[-1].lstrip("*") for p in params.split(",")] == [
            "fw", "amb", "fw_bytes", "amb_bytes", "cols", "order", "B", "nb",
            "dist", "q_end", "t_end", "stream"]
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(const["kNb"]) == da.NB and int(const["kWb"]) == da.WB
    assert const["kGuard"] == "1 << 16" and dbgather.GUARD_BASES == 1 << 16
    assert const["kBig"] == "1 << 30" and da.BIG == 1 << 30


class _FakeCudaTensor:
    """A CPU tensor that reports a CUDA device, to take the CUDA branch."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return True

    def numel(self):
        return self._t.numel()

    def data_ptr(self):
        return self._t.data_ptr()

    def __getitem__(self, index):
        return self._t[index]


def test_cuda_call_raises_without_fallback(monkeypatch):
    """On a host without a card a CUDA call raises; it never falls back
    to the plain version, and counts no launch."""
    pdb = dbgather.PackedSeqDB(
        fw=_FakeCudaTensor(torch.zeros(64, dtype=torch.uint8)),
        amb=_FakeCudaTensor(torch.zeros(64, dtype=torch.uint8)))
    cols = _FakeCudaTensor(torch.zeros((4, 7), dtype=torch.int64))

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(da, "myers_batch_db_plain", no_fallback)
    monkeypatch.setattr(da, "myers_core_plain", no_fallback)
    before = da.myers_batch_db.launches
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        da.myers_batch_db(pdb, cols)
    assert "fell back" not in str(exc.value)
    assert da.myers_batch_db.launches == before


def test_one_launch_for_all_lanes(monkeypatch):
    """On the CUDA branch every lane of a call goes to one pg_myers_align
    launch with the planes' byte counts and the lane order (descending
    t_len, stable on ties), nb is the built width, the outputs the kernel
    writes at order[i] come back in request order, and B = 0 launches
    nothing."""
    import types
    calls = []

    def launch(fn, *args):
        # the kernel's contract: lane i aligns request order[i] and
        # writes its outputs there
        calls.append((fn, args))
        cols, order = args[4]._t, args[5]
        for i, r in enumerate(order.tolist()):
            args[8]._t[r] = cols[r, 5]
            args[9]._t[r] = r
            args[10]._t[r] = i

    monkeypatch.setattr(da, "library", lambda: types.SimpleNamespace(
        pg_myers_align="pg_myers_align"))
    monkeypatch.setattr(da, "_call", launch)
    fw = _FakeCudaTensor(torch.zeros(96, dtype=torch.uint8))
    amb = _FakeCudaTensor(torch.zeros(48, dtype=torch.uint8))
    rng = np.random.default_rng(2)
    t_len = rng.integers(0, 40, 1500) * 100   # many ties
    cols = _FakeCudaTensor(torch.from_numpy(
        np.stack([t_len] * 7, 1).astype(np.int64)))
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: _FakeCudaTensor(
        torch.zeros(a[0], dtype=kw["dtype"])))
    before = da.myers_batch_db.launches
    out = da.myers_batch_db(dbgather.PackedSeqDB(fw, amb), cols)
    assert da.myers_batch_db.launches == before + 1
    [(fn, args)] = calls
    assert fn == "pg_myers_align"
    assert args[0] is fw and args[1] is amb and args[4] is cols
    assert args[2:4] == (96, 48) and args[6:8] == (1500, 8)
    order = args[5].numpy()
    np.testing.assert_array_equal(order, np.argsort(-t_len, kind="stable"))
    assert (np.diff(t_len[order]) <= 0).all()
    assert args[8:] == tuple(out)
    d, r, lane = (o._t.numpy() for o in out)
    np.testing.assert_array_equal(d, t_len)            # request order
    np.testing.assert_array_equal(r, np.arange(1500))
    np.testing.assert_array_equal(order[lane], np.arange(1500))
    with pytest.raises(ValueError, match="nb=8"):
        da.myers_batch_db(dbgather.PackedSeqDB(fw, amb), cols, nb=4)
    empty = _FakeCudaTensor(torch.zeros((0, 7), dtype=torch.int64))
    out = da.myers_batch_db(dbgather.PackedSeqDB(fw, amb), empty)
    assert len(calls) == 1 and da.myers_batch_db.launches == before + 1
    assert [o._t.shape for o in out] == [(0,)] * 3


def test_launch_order_is_longest_first_and_stable():
    """launch_order: descending t_len, request index on ties."""
    t_len = np.array([5, 9, 5, 0, 9, -3, 5], np.int64)
    cols = torch.zeros((7, 7), dtype=torch.int64)
    cols[:, 5] = torch.from_numpy(t_len)
    assert da.launch_order(cols).tolist() == [1, 4, 0, 2, 6, 3, 5]


def test_bad_inputs_raise():
    pdb = dbgather.upload_seqdb(_db([b"ACGT" * 10]).data, "cpu")
    with pytest.raises(ValueError):
        da.myers_batch_db(pdb, torch.zeros((3, 6), dtype=torch.int64))
    with pytest.raises(ValueError):
        da.myers_batch_db(pdb, torch.zeros((3, 7), dtype=torch.int32))
    with pytest.raises(ValueError):
        da.myers_batch_db(pdb, torch.zeros((3, 7), dtype=torch.int64,
                                           device="meta"))
    d, qe, te = da.myers_batch_db(pdb, torch.zeros((0, 7), dtype=torch.int64))
    assert d.shape == qe.shape == te.shape == (0,)
