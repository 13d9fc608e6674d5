"""The SHIMMER kernels on a CUDA card: each equals its plain version and
writes nothing outside its outputs (the wide route's wide_stream,
wide_emit and reduce_wide among them); the int64 scans the wide plain
versions rest on agree with the CPU.  Skipped without a card.

This file imports no jax (the card's machine has none), so it also runs
there on its own:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_card.py

Every output of a launch is a view into a larger buffer whose margins
hold a canary; a write past either end of an output changes a margin.
build_stream and emit_mask split rows into chunks of CHUNK columns,
reduce_step into chunks of REDUCE_CHUNK and compact_planes into chunks of
COMPACT_CHUNK, and carry row prefixes by a decoupled look-back over a
zeroed status buffer, and each launch zeroes the status of the launch
before it: their cases put lengths, counts, placeholders, final windows,
window winners and kept columns on chunk boundaries (torch_kernel_cases),
check what each launch published to its status and that it zeroed the
earlier one, and repeat launches on two status buffers in turn to catch
races.  The fused stage-1 pair is held to its plain composition:
gather_build_stream on packed planes (padded, and cut to the data at a
byte offset into larger buffers) at every gather residue mod 32 with N
runs across chunk boundaries, reduce_drain with each tile's look-back
publication decoded (one chain across the batch's rows), 64 batches
through one cursor against reduce_step and drain_records; the k > 16
step's reduce_wide_drain the same way against reduce_wide and
drain_records (every chunk and row slot of its two look-backs decoded,
views of wider planes), and drain_records twenty times on one cursor.
move_plane and reduce_step write only the columns below their
counts, so the columns past them keep the canary; compact_planes writes
every column, the fills past the count included.  The mesh tests put a
two-shard mesh on one card and, where there are two, one shard on each;
the two-card tests also run --mesh and --shard-overlap over both cards
and run_multihost on two ranks, one a card, over NCCL and over gloo.
"""

import numpy as np
import pytest
import torch

from peregrine_tpu_torch.ops import kernels as kn
import torch_kernel_cases as kernel_cases

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs a CUDA card: the kernels "
                                 "build with nvcc there")]
TWO_CARDS = pytest.mark.skipif(torch.cuda.device_count() < 2,
                               reason="needs two CUDA cards")

B, K, W, R = 64, 16, 80, 6
CANARY = 0x5A5A5A5A
GUARD = 4096
C, RC, SLOT = kn.CHUNK, kn.REDUCE_CHUNK, kn.STATUS_SLOT
CC = kn.COMPACT_CHUNK
CHUNKED_L = [C - 1, C, C + 1, 16384, 24576, 40960]
REDUCE_L = [RC - 1, RC, RC + 1, 2048, 5000, 40960]
COMPACT_L = [CC - 1, CC, CC + 1, 16384, 24576, 40960]


def _guarded(*shape, dtype=torch.int32):
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * GUARD,), CANARY, dtype=dtype, device="cuda")
    return buf, buf[GUARD:GUARD + n].view(shape)


def _outputs(*shapes, dtype=torch.int32):
    bufs, views = zip(*(_guarded(*s, dtype=dtype) for s in shapes))
    return list(bufs), list(views)


def _status(L, fill=0, chunk=C, rows=B):
    """A look-back status buffer for `rows` rows of length L in chunks of
    `chunk` columns, inside canary margins: zeros, or `fill` for the
    status of an earlier launch, which the launch must zero."""
    buf, view = _guarded(SLOT * (1 + rows * -(-L // chunk)))
    view.fill_(fill)
    return buf, view


def _check_status(status, L, field, counts, total, chunk=C, live=None):
    """After a launch every tile took one ticket; the first live[b] chunks
    of row b (all of them by default) each published its inclusive
    prefix, and each of those but the first its aggregate, as two 64-bit
    words with bit 0 set (field 0 of x >> 1 is a count, x >> 32 field 1),
    and the other tiles published nothing; `field` of the aggregates
    equals the per-chunk `counts` [rows, chunks], the inclusive prefixes
    are their running sums, and the last live one is the row's `total`
    (0 where no chunk is live)."""
    rows, chunks = counts.shape
    st = status.view(torch.int64).view(-1, SLOT // 2)
    assert st[0, 0] == rows * chunks and not st[0, 1:].any()
    tiles = st[1:1 + rows * chunks].view(rows, chunks, SLOT // 2)
    if live is None:
        live = torch.full((rows,), chunks, device="cuda")
    on = torch.arange(chunks, device="cuda")[None, :] < live[:, None]
    assert torch.equal((tiles[..., 2] & tiles[..., 3] & 1) == 1, on)
    assert torch.equal((tiles[:, 1:, 0] & tiles[:, 1:, 1] & 1) == 1,
                       on[:, 1:])
    assert not tiles[:, 0, :2].any() and not tiles[~on].any()

    def value(x):
        return ((x >> 32) if field else (x >> 1) & 0x7FFFFFFF).to(torch.int32)

    assert torch.equal(value(tiles[:, 1:, 0])[on[:, 1:]],
                       counts[:, 1:][on[:, 1:]])
    inclusive = value(tiles[..., 2])
    assert torch.equal(inclusive[on], counts.cumsum(1, dtype=torch.int32)[on])
    last = inclusive.gather(1, (live[:, None] - 1).clamp(min=0).long())[:, 0]
    assert torch.equal(torch.where(live > 0, last, 0), total)


def _chunk_counts(dest, L, chunk=C):
    """Kept entries (dest >= 0) per chunk of each row."""
    rows, chunks = dest.shape[0], -(-L // chunk)
    kept = torch.zeros((rows, chunks * chunk), dtype=torch.int32,
                       device="cuda")
    kept[:, :L] = (dest >= 0).int()
    return kept.view(rows, chunks, chunk).sum(2, dtype=torch.int32)


def _past_counts_untouched(plane, count):
    """A compacted plane's columns at or past each row's count still hold
    the canary: the kernel wrote only the columns below it."""
    col = torch.arange(plane.shape[1], device="cuda")[None, :]
    assert (plane[col >= count[:, None]] == CANARY).all()


def _placed(a, offset=0):
    """numpy array a on the card, starting `offset` elements past the
    allocation's (16-byte aligned) start."""
    t = torch.empty(a.size + offset, dtype=torch.from_numpy(a[:0]).dtype,
                    device="cuda")
    t[offset:] = torch.from_numpy(np.ascontiguousarray(a).ravel()).cuda()
    return t[offset:].view(a.shape)


def _launch(name, bufs, *args):
    kn._call(getattr(kn.library(), name), *args)
    torch.cuda.synchronize()
    for i, buf in enumerate(bufs):
        assert (buf[:GUARD] == CANARY).all(), f"{name}: write before output {i}"
        assert (buf[-GUARD:] == CANARY).all(), f"{name}: write past output {i}"


def _codes(rng, L):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[2, :] = 4                       # a row of ambiguous codes only
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0], lens[1], lens[2] = 0, L, L
    return (torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda())


def _prefixes_equal(got, want, count):
    valid = torch.arange(got.shape[1], device="cuda")[None, :] < count[:, None]
    assert torch.equal(got[valid], want[valid])


def _move_plane(dest, planes):
    """One guarded move_plane launch of one or two planes, checked against
    its plain version up to the kept counts, with the columns past them
    untouched; returns the plain version's planes."""
    B_, L = dest.shape
    bufs, outs = _outputs(*[(B_, L)] * len(planes))
    ptrs = list(planes) + [0] * (2 - len(planes))
    outp = list(outs) + [0] * (2 - len(outs))
    _launch("pg_move_plane", bufs, dest, ptrs[0], ptrs[1], outp[0], outp[1],
            B_, L)
    want = kn.move_plane_plain(dest, *planes)
    kept = (dest >= 0).sum(1, dtype=torch.int32)
    for got, ref in zip(outs, want):
        _prefixes_equal(got, ref, kept)
        _past_counts_untouched(got, kept)
    return want


def _reduce_step(H, P, n, r, statuses=None):
    """One guarded reduce_step launch, on a zeroed status and a junk
    earlier status, or on `statuses` ((buffer, view) of each), checked
    against its plain version (prefixes up to the count, the count, the
    columns past it untouched) and its status, and the earlier status
    checked zeroed; returns the outputs."""
    rows, L = H.shape
    bufs, (oH, oP, count) = _outputs((rows, L), (rows, L), (rows,))
    (sbuf, status), (xbuf, stale) = statuses or (
        _status(L, chunk=RC, rows=rows), _status(L, -1, chunk=RC, rows=rows))
    _launch("pg_reduce_step", bufs + [sbuf, xbuf], H, P, n, status, stale,
            stale.numel(), oH, oP, count, rows, L, r)
    wH, wP, wc = kn.reduce_step_plain(H, P, n, r)
    assert torch.equal(count, wc)
    for got, ref in ((oH, wH), (oP, wP)):
        _prefixes_equal(got, ref, wc)
        _past_counts_untouched(got, wc)
    if L > RC:
        dest = kn.reduce_columns_plain(H, P, n, r)[2]
        live = -(-n.clamp(0, L) // RC)
        _check_status(status, L, 0, _chunk_counts(dest, L, RC), count, RC,
                      live)
    else:  # rows of one chunk take no ticket and publish nothing
        assert not status.any()
    assert not stale.any()
    return oH, oP, count


@pytest.mark.parametrize("L", [1000, 8192])
def test_kernels_match_plain_and_stay_in_their_outputs(L):
    """All four kernels, at a row length that is and one that is not a
    multiple of the block's tile, with rows of length 0 and L; move_plane
    with two planes and with one."""
    codes, lens = _codes(np.random.default_rng(L), L)

    bufs, (H, P, dest, n) = _outputs((B, L), (B, L), (B, L), (B,))
    (sbuf, status), (xbuf, stale) = _status(L), _status(L, -1)
    _launch("pg_build_stream", bufs + [sbuf, xbuf], codes, lens, status,
            stale, stale.numel(), H, P, dest, n, B, L, K)
    want = kn.build_stream_plain(codes, lens, K)
    for got, ref in zip((H, P, dest, n), want):
        assert torch.equal(got, ref)
    assert not stale.any()

    sH, sP = _move_plane(dest, (H, P))
    _move_plane(dest, (H,))

    bufs, (edest, count) = _outputs((B, L), (B,))
    (sbuf, status), (xbuf, stale) = _status(L), _status(L, -1)
    _launch("pg_emit_mask", bufs + [sbuf, xbuf], sH, sP, n, status, stale,
            stale.numel(), edest, count, B, L, W, K)
    for got, ref in zip((edest, count), kn.emit_mask_plain(sH, sP, n, W, K)):
        assert torch.equal(got, ref)
    assert not stale.any()

    _reduce_step(sH, sP, n, R)


@pytest.mark.parametrize("L", [1001, 4096])
@pytest.mark.parametrize("offset", [0, 1])
def test_move_plane_scalar_and_vector_paths(L, offset):
    """Rows of a length that is not a multiple of 4, and planes that start
    4 bytes past a 16-byte boundary, take the scalar path; the others the
    16-byte loads: both equal the plain version, at keep densities from
    nothing to everything."""
    rng = np.random.default_rng(L + offset)
    keep = rng.random((B, L)) < rng.random((B, 1))
    keep[0], keep[1] = False, True
    dest = np.where(keep, np.cumsum(keep, 1) - 1, -1).astype(np.int32)
    planes = [_placed(rng.integers(-2**31, 2**31, (B, L), dtype=np.int64)
                      .astype(np.int32), offset) for _ in range(2)]
    _move_plane(_placed(dest, offset), planes)


@pytest.mark.parametrize("L", REDUCE_L)
@pytest.mark.parametrize("r", [2, R, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_reduce_step_across_chunks(L, r, ties):
    """n = 0, L, r - 2, r, on a REDUCE_CHUNK boundary and one either side;
    the least hash on the column before each boundary; all-tie hashes;
    all-equal P; random values past n, which must not be used."""
    H, P, n = kernel_cases.reduce_rows(np.random.default_rng(L + r), B, L,
                                       r, RC, ties)
    _reduce_step(torch.from_numpy(H.view(np.int32)).cuda(),
                 torch.from_numpy(P.view(np.int32)).cuda(),
                 torch.from_numpy(n).cuda(), r)


@pytest.mark.parametrize("n", [131072, 131069, 1000])
def test_reduce_step_one_long_row(n):
    """One row of 131,072 columns (43 chunks carried by the look-back),
    as stage 4's contig index gives at k <= 16, in full and cut short."""
    L = 131072
    rng = np.random.default_rng(n)
    H = rng.integers(0, 1 << 20, (1, L), dtype=np.int64).astype(np.uint32)
    P = (rng.integers(0, 1 << 30, (1, L), dtype=np.int64).astype(np.uint32)
         << np.uint32(2))
    _reduce_step(torch.from_numpy(H.view(np.int32)).cuda(),
                 torch.from_numpy(P.view(np.int32)).cuda(),
                 torch.tensor([n], dtype=torch.int32, device="cuda"), R)


def _build_stream(codes, lens, L, k, statuses=None):
    """One guarded build_stream launch, on a zeroed status and a junk
    earlier status, or on `statuses` ((buffer, view) of each), checked
    against its plain version and its status, and the earlier status
    checked zeroed; returns the outputs."""
    bufs, outs = _outputs((B, L), (B, L), (B, L), (B,))
    (sbuf, status), (xbuf, stale) = statuses or (_status(L), _status(L, -1))
    _launch("pg_build_stream", bufs + [sbuf, xbuf], codes, lens, status,
            stale, stale.numel(), *outs, B, L, k)
    for got, ref in zip(outs, kn.build_stream_plain(codes, lens, k)):
        assert torch.equal(got, ref)
    _check_status(status, L, 1, _chunk_counts(outs[2], L), outs[3])
    assert not stale.any()
    return outs


def _emit_mask(sH, sP, n, L, w, k, statuses=None):
    """One guarded emit_mask launch (statuses as for _build_stream),
    checked against its plain version and its status, and the earlier
    status checked zeroed; returns the outputs."""
    bufs, (dest, count) = _outputs((B, L), (B,))
    (sbuf, status), (xbuf, stale) = statuses or (_status(L), _status(L, -1))
    _launch("pg_emit_mask", bufs + [sbuf, xbuf], sH, sP, n, status, stale,
            stale.numel(), dest, count, B, L, w, k)
    want = kn.emit_mask_plain(sH, sP, n, w, k)
    assert torch.equal(dest, want[0]) and torch.equal(count, want[1])
    _check_status(status, L, 0, _chunk_counts(dest, L), count)
    assert not stale.any()
    return dest, count


def _stream_inputs(L, w, ties, seed):
    sH, sP, n = kernel_cases.emit_stream(np.random.default_rng(seed), B, L,
                                         w, K, C, ties)
    return (torch.from_numpy(sH.view(np.int32)).cuda(),
            torch.from_numpy(sP.view(np.int32)).cuda(),
            torch.from_numpy(n).cuda())


@pytest.mark.parametrize("L", CHUNKED_L)
@pytest.mark.parametrize("k", [5, 16])
def test_build_stream_across_chunks(L, k):
    """Rows of length 0, L, on a boundary and one either side; an all-
    ambiguous row; ambiguous bases ending at each boundary; an ambiguous
    base followed by strand-symmetric k-mers across a boundary."""
    codes, lens = kernel_cases.stream_codes(np.random.default_rng(L + k), B,
                                            L, k, C)
    _build_stream(torch.from_numpy(codes).cuda(),
                  torch.from_numpy(lens).cuda(), L, k)


@pytest.mark.parametrize("L", CHUNKED_L)
@pytest.mark.parametrize("w", [1, 5, 80, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_emit_mask_across_chunks(L, w, ties):
    """Placeholders exactly w+k-3, w+k-2 and w+k-1 columns before the least
    hash at each boundary, one at column 0, n = 0, L, on a boundary, and a
    final window across a boundary; hashes below 50 when `ties`."""
    _emit_mask(*_stream_inputs(L, w, ties, L + w), L, w, K)


def test_repeated_launches_are_identical():
    """Twenty launches of each chunked kernel on the same inputs at
    L = 40960 (ten chunks a row) give the same
    outputs, on two status buffers in turn as the wrappers use them (each
    launch zeroes the one the launch before it used): a race in the
    look-back, or a status not zeroed for the launch after, would show as
    a difference."""
    L = 40960
    codes, lens = kernel_cases.stream_codes(np.random.default_rng(7), B, L,
                                            K, C)
    codes, lens = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
    a, b = _status(L), _status(L, -1)
    turns = [(a, b), (b, a)]
    first = _build_stream(codes, lens, L, K, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_build_stream(codes, lens, L, K, turns[i % 2]),
                            first):
            assert torch.equal(got, ref)
    stream = _stream_inputs(L, W, True, 7)
    first = _emit_mask(*stream, L, W, K, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_emit_mask(*stream, L, W, K, turns[i % 2]),
                            first):
            assert torch.equal(got, ref)
    H, P, n = kernel_cases.reduce_rows(np.random.default_rng(7), B, L, R, RC,
                                       True)
    H, P, n = (torch.from_numpy(x).cuda()
               for x in (H.view(np.int32), P.view(np.int32), n))
    a, b = _status(L, chunk=RC), _status(L, -1, chunk=RC)
    turns = [(a, b), (b, a)]
    first = _reduce_step(H, P, n, R, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_reduce_step(H, P, n, R, turns[i % 2]), first):
            assert torch.equal(got, ref)


def _compact_planes(keep, planes, fills, statuses=None):
    """One guarded compact_planes launch, on a zeroed status and a junk
    earlier status, or on `statuses` ((buffer, view) of each), checked
    against its plain version on whole rows (kept entries, fills and
    count) and its status, and the earlier status checked zeroed; returns
    the outputs."""
    rows, L = keep.shape
    guarded = [_guarded(rows, L, dtype=p.dtype) for p in planes]
    guarded.append(_guarded(rows))
    bufs, outs = [g[0] for g in guarded], [g[1] for g in guarded]
    (sbuf, status), (xbuf, stale) = statuses or (
        _status(L, chunk=CC, rows=rows), _status(L, -1, chunk=CC, rows=rows))
    pad = [0] * (3 - len(planes))
    _launch("pg_compact_planes", bufs + [sbuf, xbuf], keep, *planes, *pad,
            status, stale, stale.numel(), *outs[:-1], *pad, outs[-1],
            *[kn._signed(f, 64) for f in fills], *pad,
            *[p.element_size() for p in planes], *pad, rows, L)
    want, wc = kn.compact_planes_plain(keep, planes, fills)
    assert torch.equal(outs[-1], wc)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    if L > CC:
        _check_status(status, L, 0, _chunk_counts(keep.int() - 1, L, CC),
                      wc, CC)
    else:  # rows of one chunk take no ticket and publish nothing
        assert not status.any()
    assert not stale.any()
    return outs


# plane widths: the (8, 8) instance the port launches and the generic one
# (8 + 8 + 4 was the wide sketch's stream, which wide_stream now compacts)
LAYOUTS = [(8, 8, 4), (8, 8), (4, 8, 4), (8,), (4, 4)]


def _compact_inputs(rng, keep, widths, offset=0):
    """keep and one random plane per width (int64 or int32), each placed
    `offset` elements past an aligned start, with fills of both signs."""
    planes, fills = [], []
    for i, wd in enumerate(widths):
        if wd == 8:
            a = rng.integers(-2**63, 2**63 - 1, keep.shape, dtype=np.int64)
            fills.append(-1 if i % 2 == 0 else 7)
        else:
            a = rng.integers(-2**31, 2**31, keep.shape).astype(np.int32)
            fills.append(0 if i % 2 == 0 else 0xFFFFFFFF)
        planes.append(_placed(a, offset))
    return _placed(keep, offset), planes, fills


@pytest.mark.parametrize("L", [1000, 8192])
@pytest.mark.parametrize("density", [0.98, 2 / (W + 1)])
def test_compact_planes_matches_plain_and_stays_in_its_outputs(L, density):
    """Two int64 planes and one int32 plane, whole rows (fills included),
    with rows that keep nothing and rows that keep everything."""
    rng = np.random.default_rng(L)
    keep = rng.random((B, L)) < density
    keep[0], keep[1] = False, True
    keep = torch.from_numpy(keep).cuda()
    x, y = (torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (B, L),
                                          dtype=np.int64)).cuda()
            for _ in range(2))
    li = torch.from_numpy(rng.integers(0, 2**31, (B, L)).astype(np.int32)).cuda()
    _, _, _, count = _compact_planes(keep, (x, y, li), (-1, -1, 0))
    assert count[0] == 0 and count[1] == L


@pytest.mark.parametrize("L", COMPACT_L)
@pytest.mark.parametrize("widths", LAYOUTS)
@pytest.mark.parametrize("offset", [0, 1])
def test_compact_planes_across_chunks(L, widths, offset):
    """kernel_cases.compact_rows: nothing or everything kept, the row's
    only kept column beside a boundary, one beside every boundary, counts
    on a boundary, whole chunks dropped, L = COMPACT_CHUNK - 1, COMPACT_CHUNK,
    COMPACT_CHUNK + 1 and rows of 4 to 10 chunks; every plane layout, with
    rows and planes 16-byte aligned or not (offset 1: keep rows start one
    byte, planes one element past a boundary)."""
    rng = np.random.default_rng(L + 7 * offset + len(widths))
    keep = kernel_cases.compact_rows(rng, B, L, CC)
    _compact_planes(*_compact_inputs(rng, keep, widths, offset))


@pytest.mark.parametrize("density", [0.0, 2 / (R + 1), 0.98, 1.0])
def test_compact_planes_one_long_row(density):
    """One row of 131,072 columns (32 chunks carried by the look-back), as
    stage 4's contig index gives its reduction levels at k > 16."""
    L = 131072
    rng = np.random.default_rng(int(density * 100))
    keep = rng.random((1, L)) < density
    _compact_planes(*_compact_inputs(rng, keep, (8, 8)))


def test_compact_planes_repeated_launches_are_identical():
    """Twenty compact_planes launches on the same inputs at L = 40960 (ten
    chunks a row), on two status buffers in turn as the wrappers use them:
    a race in the look-back or in the fill placement, or a status not
    zeroed for the launch after, would show as a difference."""
    L = 40960
    rng = np.random.default_rng(11)
    inputs = _compact_inputs(rng, kernel_cases.compact_rows(rng, B, L, CC),
                             (8, 8, 4))
    a, b = _status(L, chunk=CC), _status(L, -1, chunk=CC)
    turns = [(a, b), (b, a)]
    first = _compact_planes(*inputs, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_compact_planes(*inputs, turns[i % 2]), first):
            assert torch.equal(got, ref)


# --- the wide route: wide_stream, wide_emit, reduce_wide ------------------

WC = kn.REDUCE_WIDE_CHUNK
WIDE_REDUCE_L = [WC - 1, WC, WC + 1, 5000, 16384, 40960]


def _guarded_bytes(rows, L):
    """A bool [rows, L] output inside canary margins of bytes 0x5A, and the
    uint8 buffer that holds it."""
    buf = torch.full((rows * L + 2 * GUARD,), 0x5A, dtype=torch.uint8,
                     device="cuda")
    return buf, buf[GUARD:GUARD + rows * L].view(torch.bool).view(rows, L)


def _bytes_untouched(buf):
    assert (buf[:GUARD] == 0x5A).all() and (buf[-GUARD:] == 0x5A).all()


def _wide_inputs(rng, L, k):
    codes, lens = kernel_cases.wide_compact_codes(rng, B, L, k, C)
    rids = rng.integers(0, 2**40, B).astype(np.int64)
    return (torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda(),
            torch.from_numpy(rids).cuda())


def _wide_stream(codes, lens, rids, k, statuses=None):
    """One guarded wide_stream launch, on a zeroed status and a junk
    earlier status, or on `statuses`, checked against its plain version
    (the per-column stream compacted by compact_planes) below the counts,
    with the columns past them still holding the canary (the kernel
    writes nothing there), and the counts; its status decoded (each chunk
    that starts inside the read publishes its valid non-symmetric and its
    kept entries); the earlier status checked zeroed; returns the
    outputs."""
    rows, L = codes.shape
    bufs, outs = _outputs((rows, L), (rows, L), dtype=torch.int64)
    for shape in ((rows, L), (rows,)):
        buf, out = _guarded(*shape)
        bufs.append(buf)
        outs.append(out)
    (sbuf, status), (xbuf, stale) = statuses or (_status(L, rows=rows),
                                                 _status(L, -1, rows=rows))
    _launch("pg_wide_stream", bufs + [sbuf, xbuf], codes, lens, rids, status,
            stale, stale.numel(), *outs, rows, L, k)
    *want, n = kn.wide_stream_compact_plain(codes, lens, rids, k)
    assert torch.equal(outs[3], n)
    for got, ref in zip(outs, want):
        _prefixes_equal(got, ref, n)
        _past_counts_untouched(got, n)
    if L > C:
        _, _, li, keep = kn.wide_stream_plain(codes, lens, rids, k)
        vns = li > 0  # the run length is >= 1 on exactly these
        live = -(-lens.clamp(0, L) // C)
        _check_status(status, L, 0, _chunk_counts(vns.int() - 1, L),
                      vns.sum(1, dtype=torch.int32), C, live)
        _check_status(status, L, 1, _chunk_counts(keep.int() - 1, L), n, C,
                      live)
    else:  # rows of one chunk take no ticket and publish nothing
        assert not status.any()
    assert not stale.any()
    return outs


@pytest.mark.parametrize("L", CHUNKED_L)
@pytest.mark.parametrize("k", [17, 24, 28])
def test_wide_stream_across_chunks(L, k):
    """kernel_cases.wide_compact_codes: rows of length 0, 1, k - 1, L, on a
    boundary and one either side; an all-ambiguous row; ambiguous runs
    ending at each boundary and across each; (AT)* runs, all
    strand-symmetric at even k, from column 0, from just before a boundary
    to the end of the row and over one whole chunk; a row kept whole;
    rids past 2^32."""
    _wide_stream(*_wide_inputs(np.random.default_rng(L + k), L, k), k)


def _wide_emit(sx, sl, n, w, k):
    """One guarded wide_emit launch checked against its plain version."""
    rows, L = sx.shape
    ebuf, emit = _guarded_bytes(rows, L)
    _launch("pg_wide_emit", [], sx, sl, n, emit, rows, L, w, k)
    _bytes_untouched(ebuf)
    assert torch.equal(emit, kn.wide_emit_plain(sx, sl, n, w, k))
    return emit


def _emit_inputs(L, w, ties, seed, junk=False):
    rng = np.random.default_rng(seed)
    sx, sl, n = kernel_cases.wide_emit_stream(rng, B, L, w, 28, C, ties)
    if junk:  # random records and run lengths past n, where fills were
        past = np.arange(L)[None, :] >= n[:, None]
        sx[past] = rng.integers(0, 2**64, int(past.sum()), dtype=np.uint64)
        sl[past] = rng.integers(0, 2**31, int(past.sum()))
    return (torch.from_numpy(sx.view(np.int64)).cuda(),
            torch.from_numpy(sl).cuda(), torch.from_numpy(n).cuda())


@pytest.mark.parametrize("L", CHUNKED_L)
@pytest.mark.parametrize("w", [1, 2, 3, 5, 31, 32, 33, 79, 80, 81, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_wide_emit_across_chunks(L, w, ties):
    """kernel_cases.wide_emit_stream at k = 28: n = 0, L, on a boundary, a
    final window across a boundary, a final window of one repeated record,
    run lengths of w + k - 2 and w + k - 1 with the least record at each
    boundary, placeholders on the boundaries; records at and above 2^63;
    few distinct records when `ties`; w on and beside powers of two,
    whose blocks of w columns (the window runs') fall on and across the
    threads' and warps' column ranges."""
    _wide_emit(*_emit_inputs(L, w, ties, L + w + 7 * ties), w, 28)


@pytest.mark.parametrize("L", [C + 1, 16384])
@pytest.mark.parametrize("w", [5, 80, 255])
def test_wide_emit_reads_nothing_past_n(L, w):
    """Random records and run lengths past n instead of compact_planes'
    fills: the mask is the same, so the kernel read none of them."""
    _wide_emit(*_emit_inputs(L, w, False, L + w, junk=True), w, 28)


def _reduce_wide(x, y, n, r, statuses=None):
    """One guarded reduce_wide launch, on a zeroed status and a junk
    earlier status, or on `statuses`, checked against its plain version on
    whole rows (the winners, the fills and the count) and its status, and
    the earlier status checked zeroed; returns the outputs."""
    rows, L = x.shape
    bufs, outs = _outputs((rows, L), (rows, L), dtype=torch.int64)
    cbuf, count = _guarded(rows)
    (sbuf, status), (xbuf, stale) = statuses or (
        _status(L, chunk=WC, rows=rows), _status(L, -1, chunk=WC, rows=rows))
    _launch("pg_reduce_wide", bufs + [cbuf, sbuf, xbuf], x, y, n, status,
            stale, stale.numel(), *outs, count, rows, L, x.stride(0), r)
    *want, wc = kn.reduce_wide_plain(x, y, n, r)
    assert torch.equal(count, wc)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    if L > WC:
        emit = kn.reduce_wide_columns_plain(x, y, n, r)[2]
        _check_status(status, L, 0, _chunk_counts(emit.int() - 1, L, WC),
                      count, WC, -(-n.clamp(0, L) // WC))
    else:  # rows of one chunk take no ticket and publish nothing
        assert not status.any()
    assert not stale.any()
    return outs + [count]


@pytest.mark.parametrize("L", WIDE_REDUCE_L)
@pytest.mark.parametrize("r", [2, R, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_reduce_wide_across_chunks(L, r, ties):
    """kernel_cases.wide_reduce_rows: counts 0, r - 2, r - 1, L, on a
    REDUCE_WIDE_CHUNK boundary and one either side; the least hash on the
    column before each boundary; equal records; equal y; hashes >= 2^55;
    random values past the counts, which must not be read."""
    x, y, n = kernel_cases.wide_reduce_rows(np.random.default_rng(L + r), B,
                                            L, r, WC, ties)
    _reduce_wide(torch.from_numpy(x.view(np.int64)).cuda(),
                 torch.from_numpy(y.view(np.int64)).cuda(),
                 torch.from_numpy(n).cuda(), r)


@pytest.mark.parametrize("n", [131072, 131069, 1000])
def test_reduce_wide_one_long_row(n):
    """One row of 131,072 columns (64 chunks carried by the look-back), as
    stage 4's contig index gives its reduction levels at k > 16, in full
    and cut short."""
    L = 131072
    x, y, _ = kernel_cases.wide_reduce_rows(np.random.default_rng(n), 1, L,
                                            R, WC, False)
    _reduce_wide(torch.from_numpy(x.view(np.int64)).cuda(),
                 torch.from_numpy(y.view(np.int64)).cuda(),
                 torch.tensor([n], dtype=torch.int32, device="cuda"), R)


def test_wide_repeated_launches_are_identical():
    """Twenty launches of wide_stream and of reduce_wide on the same inputs
    at L = 40960, on two status buffers in turn as the wrappers use them:
    a race in the look-back, the kept ranks or the fill placement, or a
    status not zeroed for the launch after, would show as a difference."""
    L = 40960
    codes, lens, rids = _wide_inputs(np.random.default_rng(13), L, 28)
    a, b = _status(L), _status(L, -1)
    turns = [(a, b), (b, a)]
    first = _wide_stream(codes, lens, rids, 28, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_wide_stream(codes, lens, rids, 28,
                                         turns[i % 2]), first):
            assert torch.equal(got, ref)
    x, y, n = kernel_cases.wide_reduce_rows(np.random.default_rng(17), B, L,
                                            R, WC, False)
    x, y, n = (torch.from_numpy(v).cuda()
               for v in (x.view(np.int64), y.view(np.int64), n))
    a, b = _status(L, chunk=WC), _status(L, -1, chunk=WC)
    turns = [(a, b), (b, a)]
    first = _reduce_wide(x, y, n, R, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_reduce_wide(x, y, n, R, turns[i % 2]), first):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("L", [16384, 24576])
def test_wide_sketch_and_levels_on_the_card_match_the_cpu(L):
    """sketch_wide and two reduce_impl levels through the wrappers at the
    main path's B=64, k=28, w=80, r=6 (every launch on the card's own
    stream, the status pairs as the index build uses them) equal the
    cpu's, and launch each wide kernel."""
    from peregrine_tpu_torch.ops import reduce, sketch

    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.001] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    rids = np.arange(B, dtype=np.int64)
    kn.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        c, ln, rd = (torch.from_numpy(a).to(dev) for a in (codes, lens, rids))
        x, y, n = sketch.sketch_wide(c, ln, rd, w=W, k=28)
        levels = [(x, y, n)]
        for _ in range(2):
            levels.append(reduce.reduce_impl(*levels[-1], r=R))
        out[dev] = [t.cpu() for lv in levels for t in lv]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert (kn.wide_stream.launches, kn.wide_emit.launches,
            kn.reduce_wide.launches, kn.compact_planes.launches) == (1, 1, 2, 1)


def test_int64_cummin_cummax_match_the_cpu():
    """The wide sketch's window extrema rest on torch.cummin / cummax of
    int64 along the last axis, forwards and flipped, with values across
    the whole int64 range (the unsigned order after x ^ 2^63)."""
    from peregrine_tpu_torch.ops import sketch

    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (B, 512, 80),
                                      dtype=np.int64))
    a[:, :, ::7] = -1
    for op in (torch.cummin, torch.cummax):
        for t in (a, a.flip(2)):
            assert torch.equal(op(t.cuda(), dim=2).values.cpu(),
                               op(t, dim=2).values)
    flat = a.view(B, -1)
    for fn, fill in ((sketch._sliding_min_trailing, -1),
                     (sketch._sliding_max_leading, 0)):
        assert torch.equal(fn(flat.cuda(), 80, fill).cpu(),
                           fn(flat, 80, fill))


# --- the banded Myers aligner and the device pair map -------------------

def _myers_inputs(kind):
    """A packed seqdb on the card and [B, 7] request columns: the crafted
    lanes or random overlap requests of torch_kernel_cases."""
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.dbgather import upload_seqdb

    rng = np.random.default_rng(13)
    seqs, cols = (kernel_cases.myers_lanes(rng, 1500, 4096) if kind == "crafted"
                  else kernel_cases.myers_requests(rng, 300, 3000, 300, 0.01))
    db = SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)])
    return upload_seqdb(db.data, "cuda"), torch.from_numpy(cols).cuda()


def _myers_launch(pdb, cols, order):
    """One pg_myers_align launch with the given lane order; its outputs
    are views into buffers with canary margins."""
    from peregrine_tpu_torch.ops import device_align as da

    B = cols.shape[0]
    bufs, views = _outputs((B,), (B,), (B,))
    rc = da.library().pg_myers_align(
        pdb.fw.data_ptr(), pdb.amb.data_ptr(), pdb.fw.numel(),
        pdb.amb.numel(), cols.data_ptr(), order.data_ptr(), B, da.NB,
        *(v.data_ptr() for v in views),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    for buf in bufs:
        assert (buf[:GUARD] == CANARY).all() and (buf[-GUARD:] == CANARY).all()
    return views


@pytest.mark.parametrize("kind", ["crafted", "random"])
def test_myers_align_matches_plain_and_stays_in_its_outputs(kind):
    """pg_myers_align equals its plain version on every lane and writes
    its three outputs only: each lies in canary margins."""
    from peregrine_tpu_torch.ops import device_align as da

    pdb, cols = _myers_inputs(kind)
    want = da.myers_batch_db_plain(pdb, cols)
    for got, ref in zip(_myers_launch(pdb, cols, da.launch_order(cols)), want):
        assert torch.equal(got, ref)
    before = da.myers_batch_db.launches
    for got, ref in zip(da.myers_batch_db(pdb, cols), want):
        assert torch.equal(got, ref)
    assert da.myers_batch_db.launches == before + 1


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_myers_align_reads_nothing_past_the_planes(offset):
    """Planes cut to the data, given as views at a byte offset into larger
    buffers whose bytes after the planes are random junk: the crafted
    lanes (targets and queries that end on the planes' last base, strand
    1 down to the first base) and lanes whose windows run past the end,
    where gather_codes clamps to the last byte, equal the plain version
    on the same views exactly."""
    from peregrine_tpu_torch.ops import device_align as da
    from peregrine_tpu_torch.ops.dbgather import PackedSeqDB

    seqs, cols = kernel_cases.myers_lanes(np.random.default_rng(13), 1500,
                                          4096)
    cols = np.concatenate([cols, kernel_cases.myers_past_end_lanes(seqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=4096,
                                                    seed=offset)

    def view(a, n):
        buf = torch.from_numpy(np.concatenate([
            np.full(offset, 0xA5, np.uint8), a])).cuda()
        return buf[offset:offset + n]
    pdb = PackedSeqDB(fw=view(fw, nf), amb=view(amb, na))
    c = torch.from_numpy(cols).cuda()
    want = da.myers_batch_db_plain(pdb, c)
    for got, ref in zip(da.myers_batch_db(pdb, c), want):
        assert torch.equal(got, ref)


def test_myers_align_lane_order_does_not_change_outputs():
    """The same requests with their lanes launched in ascending, descending
    and shuffled length order, and given in shuffled request order, come
    back identical in request order."""
    from peregrine_tpu_torch.ops import device_align as da

    pdb, cols = _myers_inputs("random")
    want = da.myers_batch_db_plain(pdb, cols)
    t_len = cols[:, 5].cpu()
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(cols)))
    for order in (torch.sort(t_len, stable=True).indices,
                  torch.sort(t_len, descending=True, stable=True).indices,
                  perm):
        for got, ref in zip(_myers_launch(pdb, cols, order.cuda()), want):
            assert torch.equal(got, ref)
    got = da.myers_batch_db(pdb, cols[perm.cuda()])
    for g, ref in zip(got, want):
        assert torch.equal(g, ref[perm.cuda()])


def test_myers_align_repeated_launches_are_identical():
    from peregrine_tpu_torch.ops import device_align as da

    pdb, cols = _myers_inputs("random")
    first = da.myers_batch_db(pdb, cols)
    for _ in range(10):
        for got, ref in zip(da.myers_batch_db(pdb, cols), first):
            assert torch.equal(got, ref)


def test_device_pairs_on_the_card_match_the_cpu():
    """build_pairs_device on cuda equals the CPU run (itself held to the
    host build and the JAX package by the CPU tests), at k=12 and k=28."""
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.device_pairs import build_pairs_device
    from peregrine_tpu_torch.ops.index import build_index
    from peregrine_tpu_torch.simdata import random_genome, simulate_reads

    rng = np.random.default_rng(42)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    db = SeqDB.from_reads(reads)
    for k in (12, 28):
        idx = build_index(db, AsmConfig(k=k, w=24, r=4, sketch_pad_len=8192,
                                        sketch_batch=16), "cpu")
        for gates in ((2, 240, 100), (3, 6, 50)):
            on_card = build_pairs_device(idx, db.lengths, "cuda", *gates)
            on_cpu = build_pairs_device(idx, db.lengths, "cpu", *gates)
            for a, b in zip(on_card[0] + on_card[1], on_cpu[0] + on_cpu[1]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_long_route_and_map_on_the_card_match_the_cpu(tmp_path, capsys):
    """The batched long route (pieces past sketch_pad_len, several a
    sketch batch, at k=16 and k=28) and `pg-tpu-torch map` on cuda equal
    the cpu run (itself held to the JAX package by the CPU tests); map
    launches each of the four packed kernels."""
    from peregrine_tpu_torch import cli
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.index import build_index
    from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                             write_reads)

    rng = np.random.default_rng(11)
    genome = random_genome(rng, 300_000)
    cuts = [0, 12_000, 26_000, 60_000, 100_000, 300_000]
    ref = [(f"piece{i}", genome[a:b]) for i, (a, b) in
           enumerate(zip(cuts[:-1], cuts[1:]))]
    db = SeqDB.from_reads(ref)
    for k in (16, 28):
        cfg = AsmConfig(k=k, sketch_pad_len=8192)
        on_card, on_cpu = (build_index(db, cfg, dev) for dev in ("cuda", "cpu"))
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(on_card, f),
                                          getattr(on_cpu, f), err_msg=f)
    reads, _ = simulate_reads(rng, genome, read_len=5000, coverage=4.0)
    for name, seqs in (("ref", ref), ("reads", reads)):
        write_reads(seqs, str(tmp_path / f"{name}.fa"),
                    str(tmp_path / f"{name}.lst"))
        assert cli.main(["seqdb", str(tmp_path / f"{name}.lst"),
                         str(tmp_path / name)]) == 0
    args = ["map", str(tmp_path / "ref"), str(tmp_path / "reads")]
    capsys.readouterr()
    kn.reset_launches()
    assert cli.main(args + ["--device", "cuda"]) == 0
    on_card = capsys.readouterr().out
    assert all(fn.launches > 0 for fn in kn.KERNELS[:4])
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert on_card == capsys.readouterr().out
    assert len(on_card.splitlines()) > len(reads)


def test_api_on_the_card_matches_the_cpu():
    """get_shimmers_from_seq at levels 0-2 (k=16 and the wide k=24) and
    get_cns_from_reads on cuda equal the cpu run."""
    from peregrine_tpu_torch import api
    from peregrine_tpu_torch.io.seqdb import revcomp
    from peregrine_tpu_torch.simdata import mutate, random_genome

    rng = np.random.default_rng(42)
    seq = random_genome(rng, 20_000)
    for k in (16, 24):
        for levels in (0, 1, 2):
            got = api.get_shimmers_from_seq(seq, rid=5, levels=levels, k=k,
                                            device="cuda")
            want = api.get_shimmers_from_seq(seq, rid=5, levels=levels, k=k,
                                             device="cpu")
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    template = seq[:3000]
    reads = [template] + [mutate(rng, template, 0.02) for _ in range(6)]
    reads = [r if i % 2 == 0 else revcomp(r) for i, r in enumerate(reads)]
    assert api.get_cns_from_reads(reads, device="cuda") \
        == api.get_cns_from_reads(reads, device="cpu")


@pytest.mark.parametrize("cards", [
    pytest.param(("cuda:0", "cuda:0"), id="one-card"),
    pytest.param(("cuda:0", "cuda:1"), id="two-cards", marks=TWO_CARDS)])
@pytest.mark.parametrize("k", [16, 28])
def test_mesh_on_the_card_matches_the_cpu_mesh(k, cards):
    """A two-shard Mesh on the card (both shards on cuda:0, or one on each
    of two cards) gives the two-shard cpu Mesh's build_index_mesh,
    build_pairs_mesh and sharded_align (the cpu meshes are held to the
    JAX package and to the single-device builds by the CPU tests), and
    its index launches the k's kernels on the card."""
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.parallel.mesh import Mesh
    from peregrine_tpu_torch.parallel.sharded_index import build_index_mesh
    from peregrine_tpu_torch.parallel.sharded_overlap import (shard_seqdb,
                                                             sharded_align)
    from peregrine_tpu_torch.parallel.sharded_pairs import build_pairs_mesh
    from peregrine_tpu_torch.simdata import random_genome, simulate_reads

    rng = np.random.default_rng(k)
    genome = random_genome(rng, 60000)
    reads, _ = simulate_reads(rng, genome, read_len=5000, coverage=10.0)
    db = SeqDB.from_reads(reads)
    cfg = AsmConfig(k=k, sketch_pad_len=8192, sketch_batch=16)
    meshes = {"cuda": Mesh(cards), "cpu": Mesh(["cpu"] * 2)}
    kn.reset_launches()
    idx = {dev: build_index_mesh(db, cfg, m) for dev, m in meshes.items()}
    launched = [fn.__name__ for fn in kn.KERNELS if fn.launches]
    assert launched == (["compact_planes", "wide_stream", "wide_emit",
                         "reduce_wide"] if k > 16 else
                        ["build_stream", "move_plane", "emit_mask",
                         "reduce_step"])
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(idx["cuda"], f),
                                      getattr(idx["cpu"], f), err_msg=f)
    pairs = {dev: build_pairs_mesh(idx["cpu"], db.lengths, m)
             for dev, m in meshes.items()}
    for a, b in zip(pairs["cuda"][0] + pairs["cuda"][1],
                    pairs["cpu"][0] + pairs["cpu"][1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    nreq = 64
    q = rng.integers(0, len(db), nreq)
    t = rng.integers(0, len(db), nreq)
    shift = rng.integers(0, 300, nreq)
    req = (q, db.offsets[q] + shift, db.lengths[q] - shift,
           rng.integers(0, 2, nreq), t, db.offsets[t], db.lengths[t],
           rng.integers(0, 2, nreq))
    got = {dev: sharded_align(shard_seqdb(db.data, db.offsets, db.lengths, m),
                              *req, L=8192)
           for dev, m in meshes.items()}
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_array_equal(a, b)


def _multihost_reads(d):
    """tests/test_torch_multihost.py's reads (those of
    scripts/multihost_pipeline.py) in d/reads.lst."""
    from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                             write_reads)
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 60000)
    reads, _ = simulate_reads(rng, genome, read_len=4000, coverage=14.0,
                              error=0.005, circular_wrap=6000)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    return reads, lst


def _same_stage_files(a, b, rels):
    import os
    for rel in rels:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), f"{rel} differs"


@TWO_CARDS
def test_mesh_flags_on_two_cards_match_one_card(tmp_path):
    """cfg.mesh and cfg.shard_overlap over make_mesh("cuda", 2), one shard
    on each card, write one card's index, preads.ovl and p_ctg.fa (the
    same flags on a mesh of one shard, which takes the single-device
    paths: overlap_chunk_device unsharded), and launch their kernels."""
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.ops import device_align as da
    from peregrine_tpu_torch.parallel.mesh import Mesh, make_mesh
    from peregrine_tpu_torch.pipeline.run import Assembly

    reads, _ = _multihost_reads(tmp_path)
    cfg = AsmConfig(k=12, w=24, r=4, min_len=2500, sketch_pad_len=8192,
                    sketch_batch=8, use_device_aligner=True, mesh=True,
                    shard_overlap=True)
    mesh = make_mesh("cuda", 2)
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1"]
    Assembly(str(tmp_path / "one"), cfg, device="cuda",
             mesh=Mesh(["cuda:0"])).run_draft(reads=reads)
    kn.reset_launches()
    da.myers_batch_db.launches = 0
    Assembly(str(tmp_path / "two"), cfg, device="cuda",
             mesh=mesh).run_draft(reads=reads)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert all(fn.launches for fn in kn.KERNELS[:4])
    assert da.myers_batch_db.launches >= 2
    _same_stage_files(tmp_path / "one", tmp_path / "two",
                      ("1-index/shmr-L2-01-of-01.dat", "2-ovlp/preads.ovl",
                       "3-asm/p_ctg.fa"))


@TWO_CARDS
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_multihost_on_two_cards_matches_one_process(tmp_path, backend):
    """run_multihost(with_consensus=True) on two ranks, rank r on cuda:r
    (LOCAL_RANK), over NCCL and over gloo (which exchanges through host
    memory), writes the one-process run's preads.ovl, p_ctg.fa and
    p_ctg_cns.fa."""
    import os
    import subprocess
    import sys

    from peregrine_tpu_torch.pipeline.run import Assembly
    from torch_multihost_worker import PIPELINE_CFG

    _, lst = _multihost_reads(tmp_path)
    Assembly(str(tmp_path / "one"), PIPELINE_CFG,
             device="cuda").run_multihost(lst, with_consensus=True)
    out = tmp_path / "two"
    out.mkdir()
    os.symlink(lst, out / "reads.lst")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = root
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests",
                                      "torch_multihost_worker.py"),
         "pipeline", str(r), "2", f"file://{out}/init", str(out), "cuda",
         backend], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(env, LOCAL_RANK=str(r))) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-3000:]}"
        assert f'"rank": {r}' in o
    _same_stage_files(tmp_path / "one", out / "wd",
                      ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa",
                       "4-cns/p_ctg_cns.fa"))


def test_spill_sharing_on_the_card_matches_the_cpu(tmp_path, monkeypatch):
    """The pair-map sharing run of tests/test_torch_spill.py (--spill-dir,
    the spill filesystem at 0.6x the seqdb bytes free, with consensus) on
    cuda: stage 2 keeps its spilled map for stage 4, and every output of
    stages 1-4 equals the cpu run's (itself held to the JAX package by the
    CPU test)."""
    import filecmp

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.pipeline import run as prun
    from peregrine_tpu_torch.simdata import random_genome, simulate_reads

    rng = np.random.default_rng(42)
    genome = random_genome(rng, 40000)
    reads, _ = simulate_reads(rng, genome, read_len=4000, coverage=14.0)
    free = int(0.6 * SeqDB.from_reads(reads).data.nbytes)
    monkeypatch.setattr(prun, "_spill_free_bytes", lambda d: free)
    for dev in ("cuda", "cpu"):
        cfg = AsmConfig(k=12, w=24, r=4, levels=2, min_len=2500,
                        sketch_pad_len=8192, sketch_batch=16,
                        spill_dir=str(tmp_path / f"spill-{dev}"))
        asm = prun.Assembly(str(tmp_path / dev), cfg, device=dev)
        kn.reset_launches()
        asm.run_draft(reads=reads)
        assert asm._pairs is not None
        assert all(isinstance(x, np.memmap) for x in asm._pairs)
        asm.build_consensus()
        assert all((fn.launches > 0) == (dev == "cuda")
                   for fn in kn.KERNELS[:4])
    for f in ("1-index/shmr-L2-01-of-01.dat",
              "1-index/shmr-L2-MC-01-of-01.dat", "2-ovlp/preads.ovl",
              "3-asm/p_ctg.fa", "4-cns/read_map.txt", "4-cns/p_ctg_cns.fa"):
        assert filecmp.cmp(str(tmp_path / "cuda" / f),
                           str(tmp_path / "cpu" / f), shallow=False), f


# --- stage 1's batch step: gather_codes, drain_records, the fused pair,
# captured steps --------------------------------------------------------

def _byte_view(a, offset: int, n: int):
    """numpy bytes a on the card as a view of n bytes starting `offset`
    bytes into a larger buffer (whose bytes after the view are a's)."""
    buf = torch.from_numpy(np.concatenate([
        np.full(offset, 0xA5, np.uint8), a])).cuda()
    return buf[offset:offset + n]


def _gather(pdb, goff, lens, strand, L, fill, offset=0):
    """One pg_gather_codes launch into an output at `offset` bytes past a
    16-byte boundary inside margins of 0xA5, checked against
    gather_codes_plain on the same tensors, margins untouched."""
    from peregrine_tpu_torch.ops.dbgather import gather_codes_plain

    n = len(goff) * L
    buf = torch.full((n + 2 * GUARD,), 0xA5, dtype=torch.uint8, device="cuda")
    out = buf[GUARD + offset:GUARD + offset + n].view(len(goff), L)
    kn._call(kn.library().pg_gather_codes, pdb.fw, pdb.fw.numel(), pdb.amb,
             pdb.amb.numel(), goff.long(), lens.long(),
             0 if strand is None else strand.int(), out, len(goff), L, fill)
    torch.cuda.synchronize()
    assert torch.equal(out, gather_codes_plain(pdb, goff, lens, strand, L,
                                               fill))
    assert (buf[:GUARD + offset] == 0xA5).all()
    assert (buf[GUARD + offset + n:] == 0xA5).all()


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_gather_codes_matches_plain(offset):
    """pg_gather_codes equals gather_codes_plain exactly on the CPU tests'
    windows (every residue of the start mod 16, lengths 0, 1, L - 1 and
    L, strand 0, 1 and None, fill 4 and 7, L % 16 of 8 and 0), on padded
    planes and on planes cut to the data at a byte offset into larger
    buffers with junk after them (windows ending on the last base), its
    output at an offset too; and the wrapper launches it once."""
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import dbgather

    seqs = kernel_cases.gather_seqs()
    db = SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=64,
                                                    seed=offset)
    cut = dbgather.PackedSeqDB(fw=_byte_view(fw, offset, nf),
                               amb=_byte_view(amb, offset, na))
    for pdb in (dbgather.upload_seqdb(db.data, "cuda"), cut):
        for L in (264, 256):
            for strand in (0, 1):
                goff, lens, st = (torch.from_numpy(a).cuda() for a in
                                  kernel_cases.gather_windows(
                                      db.offsets, db.lengths, strand, L))
                for fill in (4, 7):
                    for s in (st, None) if strand == 0 else (st,):
                        _gather(pdb, goff, lens, s, L, fill, offset)
    before = dbgather.gather_codes.launches
    got = dbgather.gather_codes(pdb, goff.cpu(), lens.int(), st, L, 7)
    assert dbgather.gather_codes.launches == before + 1
    assert torch.equal(got, dbgather.gather_codes_plain(pdb, goff, lens, st,
                                                        L, 7))


def test_gather_codes_at_the_guard_length():
    """B=64 windows of L = GUARD_BASES (65,536) over reads of 1 to 90,000
    bases: strand-1 windows of short reads start up to L bases before the
    data, in the guard; strand-0 windows run past the data's end."""
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import dbgather
    from peregrine_tpu_torch.simdata import random_genome

    rng = np.random.default_rng(11)
    lengths = [1, 15, 17, 1000, 65535, 65536, 65537, 90000]
    db = SeqDB.from_reads([(str(i), random_genome(rng, n))
                           for i, n in enumerate(lengths)])
    pdb = dbgather.upload_seqdb(db.data, "cuda")
    L = dbgather.GUARD_BASES
    rid = np.arange(B) % len(lengths)
    off = db.offsets[rid].astype(np.int64)
    lens = np.minimum(db.lengths[rid], L).astype(np.int32)
    st = (np.arange(B) // len(lengths) % 2).astype(np.int32)
    goff = dbgather.gather_offsets(off, lens, st, off, L)
    assert goff.min() == -L + 1
    for fill in (4, 7):
        _gather(pdb, *(torch.from_numpy(a).cuda() for a in (goff, lens, st)),
                L, fill)


@pytest.mark.parametrize("k", [16, 28])
def test_drain_records_matches_plain(k):
    """pg_drain_records equals drain_records_plain exactly: three batches
    of 64 rows through one device cursor (counts 0, exactly the width,
    past it, and random; rows wider than the width drained; at k=28
    records with hashes >= 2^55), the stream and its untouched tail, the
    count slots and the cursors; then a stream that ends before the
    records, which keeps the ones that fit and counts them all."""
    Cw = 300  # more columns than a block's threads
    batches = kernel_cases.drain_batches(k, 3, B, Cw)
    total = sum(int(np.minimum(bt[2], Cw).sum()) for bt in batches)
    dt = np.int32 if k <= 16 else np.int64
    for size, slots in ((total + 40, 4), (total - 37, None)):
        outs = {}
        for dev in ("cpu", "cuda"):
            out = torch.full((size, 2), 7, dtype=torch.int64, device=dev)
            counts = (None if slots is None else torch.full(
                (slots, 2, B + 3), -5, dtype=torch.int32, device=dev))
            cursor = torch.zeros(3, dtype=torch.int64, device=dev)
            for a, b, c, c0, rids in batches:
                kn.drain_records(
                    *(torch.from_numpy(p.view(dt)).to(dev) for p in (a, b)),
                    torch.from_numpy(rids).to(dev),
                    torch.from_numpy(c).to(dev), torch.from_numpy(c0).to(dev),
                    cursor, out, counts, k=k, width=Cw)
            outs[dev] = (out, counts, cursor)
        torch.cuda.synchronize()
        for got, want in zip(outs["cuda"], outs["cpu"]):
            if want is not None:
                assert torch.equal(got.cpu(), want)
        assert outs["cuda"][2].tolist() == [total, 3, 0]


# --- the fused pair: gather_build_stream, reduce_drain --------------------

FUSED_L = [C - 8, C, C + 8, 16384, 24576]  # multiples of 8, as the gather


def _fused_planes(L, offset):
    """fused_gather_seqs(L) on the card twice: upload_seqdb's planes, and
    planes cut to the data at `offset` bytes into larger buffers with junk
    after them; and 64 windows (every residue mod 32, lengths on and
    beside a chunk boundary, tails past the data, N runs across chunk
    boundaries) as int64 on the card."""
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import dbgather

    seqs = kernel_cases.fused_gather_seqs(L)
    db = SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=64,
                                                    seed=offset)
    cut = dbgather.PackedSeqDB(fw=_byte_view(fw, offset, nf),
                               amb=_byte_view(amb, offset, na))
    goff, lens = kernel_cases.fused_gather_windows(db.offsets, db.lengths, L,
                                                   rows=B)
    return ((dbgather.upload_seqdb(db.data, "cuda"), cut),
            torch.from_numpy(goff).cuda(), torch.from_numpy(lens).cuda())


def _gather_build_stream(pdb, goff, lens, L, k, statuses=None):
    """One guarded pg_gather_build_stream launch (statuses as for
    _build_stream), checked against gather_build_stream_plain and its
    status (build_stream's look-back), and the earlier status checked
    zeroed; returns the outputs."""
    bufs, outs = _outputs((B, L), (B, L), (B, L), (B,))
    (sbuf, status), (xbuf, stale) = statuses or (_status(L), _status(L, -1))
    _launch("pg_gather_build_stream", bufs + [sbuf, xbuf], pdb.fw,
            pdb.fw.numel(), pdb.amb, pdb.amb.numel(), goff, lens, status,
            stale, stale.numel(), *outs, B, L, k)
    for got, ref in zip(outs, kn.gather_build_stream_plain(pdb, goff, lens,
                                                           L, k)):
        assert torch.equal(got, ref)
    _check_status(status, L, 1, _chunk_counts(outs[2], L), outs[3])
    assert not stale.any()
    return outs


@pytest.mark.parametrize("L", FUSED_L)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_gather_build_stream_matches_plain(L, offset):
    """pg_gather_build_stream equals the plain gather and build (and the
    two kernels it replaces, launched in turn) at k = 5 and 16, on
    upload_seqdb's planes and on planes cut to the data at an offset
    into larger buffers; the wrapper launches it once."""
    from peregrine_tpu_torch.ops import dbgather

    planes, goff, lens = _fused_planes(L, offset)
    for pdb in planes:
        for k in (5, K):
            got = _gather_build_stream(pdb, goff, lens, L, k)
            codes = dbgather.gather_codes(pdb, goff, lens, None, L, 4)
            for a, b in zip(got, kn.build_stream(codes, lens.int(), k=k)):
                assert torch.equal(a, b)
    before = kn.gather_build_stream.launches
    got = kn.gather_build_stream(pdb, goff, lens, L, k=K)
    assert kn.gather_build_stream.launches == before + 1
    for a, b in zip(got, kn.gather_build_stream_plain(pdb, goff, lens, L, K)):
        assert torch.equal(a, b)


def _records_op(a, b, width):
    """reduce_drain's look-back operator (Records, RecordsOp in the .cu
    file) on (s, f, o, c) tuples: a followed by b."""
    if not b[0]:
        return (a[0], a[1] if a[0] else a[1] + b[1],
                a[2] + b[1] if a[0] else 0, a[3])
    if not a[0]:
        return (1, a[1] + b[1], b[2], b[3])
    return (1, a[1], b[2], a[3] + min(width, a[2] + b[1]) + b[3])


def _records_words(x, y):
    return ((x >> 51) & 1, (x >> 1) & 0x1FFFFFF, (x >> 26) & 0x1FFFFFF,
            y >> 1)


def _check_drain_status(status, H, P, n, r, width, base):
    """Every tile of the batch (chunk j of row b is tile b * chunks + j)
    took a ticket and published its inclusive prefix, and each but tile 0
    its aggregate, as (s, f, o, c) words with bit 0 set: the aggregate of
    a row's first chunk is (1, 0, e, 0) and of a later one (0, e, 0, 0),
    e its emitted entries; the inclusive prefixes run from tile 0's, which
    holds the cursor base; returns the last one's record count."""
    rows, L = H.shape
    chunks = -(-L // RC)
    dest = kn.reduce_columns_plain(H, P, n, r)[2]
    e = _chunk_counts(dest, L, RC).cpu().tolist()
    st = status.view(torch.int64).view(-1, SLOT // 2).cpu().tolist()
    assert st[0][0] == rows * chunks and not any(st[0][1:])
    acc = (1, 0, 0, base)
    for t in range(rows * chunks):
        b, j = divmod(t, chunks)
        ax, ay, ix, iy = st[1 + t]
        v = (1, 0, e[b][j], 0) if j == 0 else (0, e[b][j], 0, 0)
        if t == 0:
            assert ax == ay == 0
        else:
            assert ax & ay & 1 and _records_words(ax, ay) == v
        acc = _records_op(acc, v, width)
        assert ix & iy & 1 and _records_words(ix, iy) == acc, t
    assert not any(any(w) for w in st[1 + rows * chunks:])
    return acc[3] + min(width, acc[2])


def _reduce_drain(H, P, n, r, width, base=0, statuses=None, slots=4):
    """One guarded pg_reduce_drain launch into a stream and count slots
    inside canary margins, its cursor at `base` and slot 1, checked
    against reduce_drain_plain (the stream, its untouched tail, the slots
    and the cursors) and its status, and the earlier status checked
    zeroed; returns (stream, counts, cursor)."""
    rows, L = H.shape
    rng = np.random.default_rng(L + r)
    rids = torch.from_numpy(rng.integers(0, 1 << 31, rows)).cuda()
    c0 = n + 11
    size = base + rows * width + 5
    (obuf, out), (cbuf, counts) = (_guarded(size, 2, dtype=torch.int64),
                                   _guarded(slots, 2, rows + 3))
    cursor = torch.tensor([base, 1, 0], dtype=torch.int64, device="cuda")
    (sbuf, status), (xbuf, stale) = statuses or (
        _status(L, chunk=RC, rows=rows), _status(L, -1, chunk=RC, rows=rows))
    _launch("pg_reduce_drain", [obuf, cbuf, sbuf, xbuf], H, P, n, rids, c0,
            status, stale, stale.numel(), cursor, out, counts, rows, L, r, K,
            width, size, slots, rows + 3)
    want = (out.clone().fill_(CANARY), counts.clone().fill_(CANARY),
            torch.tensor([base, 1, 0], dtype=torch.int64, device="cuda"))
    kn.reduce_drain_plain(H, P, n, rids, c0, want[2], want[0], want[1], r=r,
                          k=K, width=width)
    for got, ref in zip((out, counts, cursor), want):
        assert torch.equal(got, ref)
    end = _check_drain_status(status, H, P, n, r, width, base)
    assert cursor.tolist() == [end, 2, 0]
    assert not stale.any()
    return out, counts, cursor


@pytest.mark.parametrize("L", REDUCE_L)
@pytest.mark.parametrize("r", [2, R, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_reduce_drain_across_chunks(L, r, ties):
    """pg_reduce_drain equals reduce_step then drain_records (plain) on
    reduce_rows' rows (n = 0, L, short of a window, on and beside a chunk
    boundary, a winner across one, all ties, one P), at a width below
    the counts and at the full width, from a cursor that is not 0."""
    H, P, n = kernel_cases.reduce_rows(np.random.default_rng(L + r), B, L, r,
                                       RC, ties)
    H, P, n = (torch.from_numpy(x).cuda()
               for x in (H.view(np.int32), P.view(np.int32), n))
    for width in (min(L, 40), L):
        _reduce_drain(H, P, n, r, width, base=123)


def test_reduce_drain_at_the_draft_level():
    """The draft's final level: level 2 of random codes' capped sketch at
    the main path's shape (B=64, cap 2,048, out_cap columns)."""
    rng = np.random.default_rng(5)
    codes, lens = _codes(rng, 16384)
    from peregrine_tpu_torch.ops.index import index_planes
    H, P, c, _ = index_planes(codes, lens, torch.zeros(B, dtype=torch.int64,
                                                       device="cuda"),
                              w=W, k=K, r=R, levels=1, cap=2048)
    out_w = max(64, 2048 // int((R / 2) ** 2))
    _reduce_drain(H, P, c, R, out_w)


def test_fused_repeated_launches_are_identical():
    """Twenty launches of each fused kernel on the same inputs, on two
    status buffers in turn (each launch zeroes the one before it used):
    gather_build_stream at L = 24,576 (six chunks a row), reduce_drain at
    L = 40,960 (fourteen chunks a row, one chain across the batch)."""
    L = 24576
    (pdb, _), goff, lens = _fused_planes(L, 0)
    a, b = _status(L), _status(L, -1)
    turns = [(a, b), (b, a)]
    first = _gather_build_stream(pdb, goff, lens, L, K, turns[0])
    for i in range(1, 20):
        for got, ref in zip(_gather_build_stream(pdb, goff, lens, L, K,
                                                 turns[i % 2]), first):
            assert torch.equal(got, ref)
    L = 40960
    H, P, n = kernel_cases.reduce_rows(np.random.default_rng(9), B, L, R, RC,
                                       True)
    H, P, n = (torch.from_numpy(x).cuda()
               for x in (H.view(np.int32), P.view(np.int32), n))
    a, b = _status(L, chunk=RC), _status(L, -1, chunk=RC)
    turns = [(a, b), (b, a)]
    first = _reduce_drain(H, P, n, R, 300, statuses=turns[0])
    for i in range(1, 20):
        for got, ref in zip(_reduce_drain(H, P, n, R, 300,
                                          statuses=turns[i % 2]), first):
            assert torch.equal(got, ref)


def test_reduce_drain_through_one_cursor_equals_drain_records():
    """64 batches of 64 rows through one cursor and 64 count slots: the
    wrapper's stream, slots and cursor equal reduce_step followed by
    drain_records, both launched on the card, through another; one
    launch a batch."""
    rng = np.random.default_rng(64)
    L, width = 2048, 227
    n_rec = 64 * B * width
    streams = [(torch.full((n_rec, 2), 7, dtype=torch.int64, device="cuda"),
                torch.full((64, 2, B), -5, dtype=torch.int32, device="cuda"),
                torch.zeros(3, dtype=torch.int64, device="cuda"))
               for _ in range(2)]
    before = kn.reduce_drain.launches
    for g in range(64):
        H, P, n = kernel_cases.reduce_rows(rng, B, L, R, RC, g % 3 == 0)
        H, P, n = (torch.from_numpy(x).cuda()
                   for x in (H.view(np.int32), P.view(np.int32), n))
        rids = torch.from_numpy(rng.integers(0, 1 << 31, B)).cuda()
        c0 = n + 3
        out, counts, cursor = streams[0]
        kn.reduce_drain(H, P, n, rids, c0, cursor, out, counts, r=R, k=K,
                        width=width)
        out, counts, cursor = streams[1]
        oH, oP, c = kn.reduce_step(H, P, n, r=R)
        kn.drain_records(oH, oP, rids, c, c0, cursor, out, counts, k=K,
                         width=width)
    torch.cuda.synchronize()
    assert kn.reduce_drain.launches == before + 64
    for got, ref in zip(*streams):
        assert torch.equal(got, ref)
    assert streams[0][2][1] == 64


# --- the wide tail: reduce_wide on views, reduce_wide_drain, drain_records


def _wide_rows(L, r, ties, seed, rows=B, cols=None):
    """wide_reduce_rows on the card: (x, y, n) of `rows` rows of L
    columns, as [:, :L] views of planes of `cols` columns (the columns
    past L random records, which nothing may read) where cols is given."""
    rng = np.random.default_rng(seed)
    x, y, n = kernel_cases.wide_reduce_rows(rng, rows, L, r, WC, ties)
    if cols is not None:
        pad = rng.integers(-2**63, 2**63 - 1, (2, rows, cols - L))
        x = np.concatenate([x.view(np.int64), pad[0]], 1)
        y = np.concatenate([y.view(np.int64), pad[1]], 1)
    x, y, n = (torch.from_numpy(np.ascontiguousarray(v).view(np.int64))
               .cuda() if v.dtype != np.int32 else torch.from_numpy(v).cuda()
               for v in (x, y, n))
    return x[:, :L], y[:, :L], n


@pytest.mark.parametrize("L", [WC - 1, WC + 1, 5000])
@pytest.mark.parametrize("r", [2, R, 255])
def test_reduce_wide_reads_views_in_place(L, r):
    """reduce_wide on [:, :L] views of planes 1,000 columns wider (junk
    past L, and counts past L, as the step's capped sketch holds them)
    equals its plain version on whole rows and the launch on contiguous
    copies, with every look-back slot and the canary margins checked."""
    x, y, n = _wide_rows(L, r, False, L + r, cols=L + 1000)
    n[10:20] = L + 300
    assert x.stride(0) == L + 1000
    got = _reduce_wide(x, y, n, r)
    for a, b in zip(got, _reduce_wide(x.contiguous(), y.contiguous(), n, r)):
        assert torch.equal(a, b)


def _wide_drain_statuses(L, rows=B):
    """reduce_wide_drain's status, a slot a chunk and a slot a row, and an
    earlier one of junk, inside canary margins."""
    return tuple(_status(L + WC, fill, chunk=WC, rows=rows)
                 for fill in (0, -1))


def _check_wide_drain_status(status, x, y, n, r, width, base):
    """Every tile (chunk j of row b is tile b * chunks + j) took a ticket.
    Where a row has more than one chunk, its chunk 0 published its
    emitted entries as its inclusive prefix and each later chunk below n
    its entries as its aggregate and the row's running sum as its
    inclusive prefix; chunks past n published nothing.  Then a slot a
    row: each row's last chunk published the row's records min(count,
    width) as its aggregate (but row 0) and the running sum of the
    records from the cursor base as its inclusive prefix; all as count
    words with bit 0 set.  Returns the last row's inclusive prefix."""
    rows, L = x.shape
    chunks = -(-L // WC)
    emit = kn.reduce_wide_columns_plain(x, y, n, r)[2]
    e = _chunk_counts(emit.int() - 1, L, WC).cpu().tolist()
    nn = n.clamp(0, L).cpu().tolist()
    st = status.view(torch.int64).view(-1, SLOT // 2).cpu().tolist()
    tiles = rows * chunks
    assert st[0][0] == tiles and not any(st[0][1:])

    def word(v):
        return [2 * v + 1, 1]

    acc = base
    for b in range(rows):
        run = 0
        for j in range(chunks):
            got = st[1 + b * chunks + j]
            run += e[b][j]
            if chunks == 1 or (j > 0 and j * WC >= nn[b]):
                assert not any(got), (b, j)
            else:
                assert got == ([0, 0] if j == 0 else word(e[b][j])) + word(
                    run), (b, j)
        recs = min(width, run)
        acc += recs
        assert st[1 + tiles + b] == ([0, 0] if b == 0 else word(recs)) + \
            word(acc), b
    assert not any(any(w) for w in st[1 + tiles + rows:])
    return acc


def _reduce_wide_drain(x, y, n, r, width, base=0, statuses=None, slots=4):
    """One guarded pg_reduce_wide_drain launch into a stream and count
    slots inside canary margins, its cursor at `base` and slot 1, checked
    against reduce_wide_drain_plain (the stream, its untouched tail, the
    slots and the cursors) and its status (every look-back slot decoded),
    and the earlier status checked zeroed; returns (stream, counts,
    cursor)."""
    rows, L = x.shape
    c0 = n + 11
    size = base + rows * width + 5
    (obuf, out), (cbuf, counts) = (_guarded(size, 2, dtype=torch.int64),
                                   _guarded(slots, 2, rows + 3))
    cursor = torch.tensor([base, 1, 0], dtype=torch.int64, device="cuda")
    (sbuf, status), (xbuf, stale) = statuses or _wide_drain_statuses(L,
                                                                     rows)
    _launch("pg_reduce_wide_drain", [obuf, cbuf, sbuf, xbuf], x, y, n, c0,
            status, stale, stale.numel(), cursor, out, counts, rows, L,
            x.stride(0), r, width, size, slots, rows + 3)
    want = (out.clone().fill_(CANARY), counts.clone().fill_(CANARY),
            torch.tensor([base, 1, 0], dtype=torch.int64, device="cuda"))
    kn.reduce_wide_drain_plain(x, y, n, c0, want[2], want[0], want[1], r=r,
                               width=width)
    for got, ref in zip((out, counts, cursor), want):
        assert torch.equal(got, ref)
    end = _check_wide_drain_status(status, x, y, n, r, width, base)
    assert cursor.tolist() == [end, 2, 0]
    assert not stale.any()
    return out, counts, cursor


@pytest.mark.parametrize("L", WIDE_REDUCE_L)
@pytest.mark.parametrize("r", [2, R, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_reduce_wide_drain_across_chunks(L, r, ties):
    """pg_reduce_wide_drain equals reduce_wide then drain_records (plain)
    on wide_reduce_rows' rows (counts 0, r - 2, r - 1, on and beside a
    REDUCE_WIDE_CHUNK boundary, L; the least hash before each boundary;
    equal records; equal y; hashes >= 2^55), at a width below the counts
    and at the full width, from a cursor that is not 0; at L = 5000 also
    on [:, :L] views of wider planes."""
    x, y, n = _wide_rows(L, r, ties, L + r)
    for width in (min(L, 40), L):
        _reduce_wide_drain(x, y, n, r, width, base=123)
    if L == 5000:
        xv, yv, _ = _wide_rows(L, r, ties, L + r, cols=L + 777)
        assert torch.equal(xv, x) and xv.stride(0) == L + 777
        _reduce_wide_drain(xv, yv, n, r, 40, base=5)


def test_reduce_wide_drain_at_the_step_level():
    """The k=28 step's final level: level 2 of random codes' capped wide
    sketch at the main path's shape (B=64, L=16,384, cap 2,048, out_cap
    columns), level 1 read from the sketch's planes in place."""
    from peregrine_tpu_torch.ops.index import index_planes
    rng = np.random.default_rng(6)
    codes, lens = _codes(rng, 16384)
    x, y, c, _ = index_planes(codes, lens, torch.arange(
        B, dtype=torch.int64, device="cuda"), w=W, k=28, r=R, levels=1,
        cap=2048)
    out_w = max(64, 2048 // int((R / 2) ** 2))
    _reduce_wide_drain(x, y, c, R, out_w)


def test_reduce_wide_drain_repeated_launches_are_identical():
    """Twenty launches on the same rows of L = 40,960 (twenty chunks a
    row, one chain across the batch), on two status buffers in turn
    (each launch zeroes the one before it used)."""
    L = 40960
    x, y, n = _wide_rows(L, R, True, 9)
    a, b = _wide_drain_statuses(L)
    turns = [(a, b), (b, a)]
    first = _reduce_wide_drain(x, y, n, R, 300, statuses=turns[0])
    for i in range(1, 20):
        for got, ref in zip(_reduce_wide_drain(x, y, n, R, 300,
                                               statuses=turns[i % 2]), first):
            assert torch.equal(got, ref)


def test_reduce_wide_drain_through_one_cursor_equals_drain_records():
    """64 batches of 64 rows, read as [:, :2048] views of 3,000-column
    planes, through one cursor and 64 count slots: the wrapper's stream,
    slots and cursor equal reduce_wide followed by drain_records, both
    launched on the card, through another; one launch a batch."""
    rng = np.random.default_rng(64)
    L, width = 2048, 227
    n_rec = 64 * B * width
    streams = [(torch.full((n_rec, 2), 7, dtype=torch.int64, device="cuda"),
                torch.full((64, 2, B), -5, dtype=torch.int32, device="cuda"),
                torch.zeros(3, dtype=torch.int64, device="cuda"))
               for _ in range(2)]
    before = kn.reduce_wide_drain.launches
    for g in range(64):
        x, y, n = _wide_rows(L, R, g % 3 == 0, int(rng.integers(1 << 30)),
                             cols=3000)
        c0 = n + 3
        out, counts, cursor = streams[0]
        kn.reduce_wide_drain(x, y, n, c0, cursor, out, counts, r=R,
                             width=width)
        out, counts, cursor = streams[1]
        ox, oy, c = kn.reduce_wide(x, y, n, r=R)
        kn.drain_records(ox, oy, None, c, c0, cursor, out, counts, k=28,
                         width=width)
    torch.cuda.synchronize()
    assert kn.reduce_wide_drain.launches == before + 64
    for got, ref in zip(*streams):
        assert torch.equal(got, ref)
    assert streams[0][2][1] == 64


@pytest.mark.parametrize("k", [16, 28])
@pytest.mark.parametrize("Cw", [1000, 16384])
def test_drain_records_repeated_launches_on_one_cursor(k, Cw):
    """pg_drain_records twenty times on one cursor (the level-0 stream's
    width of 16,384 and rows longer than the columns a block loads before
    its count, at 1,000), from a stream inside canary margins and count
    slots past which nothing is written: the stream, slots and cursors
    equal drain_records_plain's twenty times over; rows of count 0,
    exactly the width and past it; the planes as [:, :Cw + 1] views of
    wider ones; (H, P) planes at k=16, int64 records at k=28."""
    a, b, c, c0, rids = kernel_cases.drain_batches(k, 1, B, Cw)[0]
    c[3:9] = 0
    dt = np.int32 if k <= 16 else np.int64
    total = int(np.minimum(c, Cw).sum())
    reps, slots = 20, 24
    outs = {}
    for dev in ("cpu", "cuda"):
        pa, pb = (torch.from_numpy(p.view(dt)).to(dev)[:, :Cw + 1]
                  for p in (a, b))
        buf = torch.full((reps * total + 2 * GUARD, 2), CANARY,
                         dtype=torch.int64, device=dev)
        out = buf[GUARD:GUARD + reps * total]
        counts = torch.full((slots, 2, B), -5, dtype=torch.int32, device=dev)
        cursor = torch.zeros(3, dtype=torch.int64, device=dev)
        for _ in range(reps):
            kn.drain_records(pa, pb, torch.from_numpy(rids).to(dev),
                             torch.from_numpy(c).to(dev),
                             torch.from_numpy(c0).to(dev), cursor, out,
                             counts, k=k, width=Cw)
        outs[dev] = (buf, counts, cursor)
    torch.cuda.synchronize()
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(got.cpu(), want)
    buf, counts, cursor = outs["cuda"]
    assert (buf[:GUARD] == CANARY).all() and (buf[-GUARD:] == CANARY).all()
    assert cursor.tolist() == [reps * total, reps, 0]
    assert (counts[reps:] == -5).all()


def _stage1_steps(dev, packed, batches):
    """The two shapes the captured-step test alternates: k=16 at pad 2048
    (capped) and k=28 at pad 4096 with the level-0 stream, four rows."""
    from peregrine_tpu_torch.ops import index

    return [index._Stage1Step(packed, torch.device(dev), 2048, 4, 256, False,
                              dict(w=24, k=16, r=4, levels=2), batches),
            index._Stage1Step(packed, torch.device(dev), 4096, 4, 0, True,
                              dict(w=24, k=28, r=4, levels=2), batches)]


def test_captured_steps_match_the_eager_steps():
    """Two stage-1 shapes captured as CUDA graphs and replayed 20 times in
    turn, on batches of torch_kernel_cases.stage1_reads, write the same
    record streams, level-0 stream and count slots as the same steps run
    eagerly on the CPU; each replay adds the launches its graph holds
    (none counted at capture); the look-back status that eager launches
    take next stays zeroed."""
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.dbgather import upload_seqdb

    db = SeqDB.from_reads(kernel_cases.stage1_reads())
    groups = [np.arange(0, 16), np.arange(16, 22)]
    runs = {}
    for dev in ("cpu", "cuda"):
        steps = _stage1_steps(dev, upload_seqdb(db.data, dev), 10)
        kn.reset_launches()
        for i in range(20):
            rids = groups[i % 2]
            part = rids[(i // 2 * 4) % len(rids):][:4]
            meta = np.stack([db.offsets[part].astype(np.int64),
                             db.lengths[part].astype(np.int64),
                             part.astype(np.int64)])
            assert steps[i % 2].run(meta, part) == (i >= 18)
        runs[dev] = steps
        launches = {fn.__name__: fn.launches for fn in kn.KERNELS}
    torch.cuda.synchronize()
    for cpu, card in zip(runs["cpu"], runs["cuda"]):
        n = int(cpu.cursor[0])
        assert card.cursor.tolist() == cpu.cursor.tolist() == [n, 10, 0]
        assert torch.equal(card.rec[:n].cpu(), cpu.rec[:n])
        # the CPU step runs each batch's rows alone: a short batch's
        # padded rows on the card counted 0 records
        m = [len(p) for p in cpu.parts]
        for i, rows in enumerate(m):
            assert torch.equal(card.counts[i, :, :rows].cpu(),
                               cpu.counts[i, :, :rows])
            assert not card.counts[i, :, rows:].any()
    n0 = int(runs["cpu"][1].cursor0[0])
    assert torch.equal(runs["cuda"][1].rec0[:n0].cpu(), runs["cpu"][1].rec0[:n0])
    # k=16: the gather and build_stream, and level 2 and the drain, fused
    names = {fn.__name__: n for fn, n in runs["cuda"][0].per_replay.items()}
    assert names == {"gather_build_stream": 1, "move_plane": 2,
                     "emit_mask": 1, "reduce_step": 1, "reduce_drain": 1}
    # k=28: level 2 and the drain fused, the level-0 stream drained alone
    names = {fn.__name__: n for fn, n in runs["cuda"][1].per_replay.items()}
    assert names == {"gather_codes": 1, "wide_stream": 1,
                     "compact_planes": 1, "wide_emit": 1, "reduce_wide": 1,
                     "reduce_wide_drain": 1, "drain_records": 1}
    # ten replays of each graph and one eager warm-up of each shape
    assert launches["gather_build_stream"] == launches["wide_stream"] == 11
    assert launches["reduce_drain"] == 11 and launches["build_stream"] == 0
    assert launches["gather_codes"] == 11 and launches["drain_records"] == 11
    assert launches["reduce_wide_drain"] == 11
    assert not any(bool(pair[0].any()) for pair in kn._status_pairs.values())


def test_build_index_on_the_card_matches_the_cpu_across_groups(monkeypatch):
    """build_index on cuda equals the CPU's in fetch groups of three
    batches (four batches in the 2048 bucket, two in the 4096 one): at
    k=16, at k=28 with w=8 (the second batch of the first group and both
    of the second bucket overflow their caps and are retried) and at k=28
    with the level-0 index; one replay a batch, one fetch a group."""
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import index

    monkeypatch.setattr(index, "FETCH_GROUP", 3)
    db = SeqDB.from_reads(kernel_cases.stage1_reads())
    for k, w, keep_l0 in ((16, 24, False), (28, 8, False), (28, 24, True)):
        cfg = AsmConfig(k=k, w=w, r=4, levels=2, sketch_pad_len=8192,
                        sketch_batch=4)
        index.reset_stats()
        on_card = index.build_index(db, cfg, "cuda", keep_l0=keep_l0)
        stats = dict(index.STATS)
        on_host = index.build_index(db, cfg, "cpu", keep_l0=keep_l0)
        pairs = zip(on_card, on_host) if keep_l0 else [(on_card, on_host)]
        for a, b in pairs:
            for f in ("x", "y", "mc_hash", "mc_count"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert stats["replays"] == 6 and stats["group_fetches"] == 3
        assert stats["retried_batches"] == (3 if w == 8 else 0)
        assert len(stats["graph_pool_bytes"]) == 2


# --- the seqdb uploader ----------------------------------------------------

@pytest.mark.parametrize("amb", [False, True], ids=["acgt", "ambiguous"])
def test_seqdb_uploader_on_the_card_matches_upload_seqdb_and_the_cpu(
        amb, monkeypatch):
    """SeqDBUploader on cuda, fed in 4096-base chunks with a ragged tail
    and pieces of 4 KiB (so that the three staging buffers turn over many
    times), equals upload_seqdb on cuda and the cpu planes; without an
    ambiguous base the amb plane is elided (no byte of it copied) and
    zero."""
    from peregrine_tpu_torch.ops import dbgather as dg

    rng = np.random.default_rng(5)
    n = 1_500_000 + 333
    data = (rng.integers(0, 16, n, dtype=np.uint8) if amb else
            rng.choice(np.array([1, 2, 4, 8], np.uint8), n))
    want = dg.upload_seqdb(data, "cpu")
    bulk = dg.upload_seqdb(data, "cuda")
    monkeypatch.setattr(dg.SeqDBUploader, "PIECE_FW_BYTES", 4096)
    up = dg.SeqDBUploader("cuda", est_bases=n)
    for i in range(0, n, 4096):
        up.feed(data[i:i + 4096])
    got = up.finish()
    for planes in (bulk, got):
        assert planes.fw.is_cuda and planes.amb.is_cuda
        assert torch.equal(planes.fw.cpu(), want.fw)
        assert torch.equal(planes.amb.cpu(), want.amb)
    assert up.stats["pieces"] > 3 * dg.SeqDBUploader.N_STAGING
    # the guard's amb bytes (four whole pieces) are zero, and so is every
    # amb byte of ACGT
    assert up.stats["elided_bytes"] == (
        dg.GUARD_BASES // 8 if amb else -(-(dg.GUARD_BASES + n) // 8))
    assert bool(got.amb.any()) == amb


def test_assembly_on_the_card_takes_the_stage0_planes(tmp_path, caplog):
    """An Assembly on cuda from a manifest starts the uploader in stage 0
    and builds stage 1 on its planes (the log says so), writing the same
    1-index files as an Assembly on the cpu."""
    import filecmp
    import logging

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.pipeline.run import Assembly
    from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                             write_reads)

    rng = np.random.default_rng(8)
    genome = random_genome(rng, 60000)
    reads, _ = simulate_reads(rng, genome, read_len=4000, coverage=12.0)
    lst = str(tmp_path / "reads.lst")
    write_reads(reads, str(tmp_path / "reads.fa"), lst)
    cfg = AsmConfig(k=16, w=24, r=4, levels=2, sketch_pad_len=8192,
                    sketch_batch=16)
    for dev in ("cuda", "cpu"):
        asm = Assembly(str(tmp_path / dev), cfg, device=dev)
        with caplog.at_level(logging.INFO, logger="peregrine_tpu_torch"):
            caplog.clear()
            asm.build_db(reads_list=lst)
            assert (asm._uploader is not None) == (dev == "cuda")
            asm.build_shimmer_index()
        msgs = [r.getMessage() for r in caplog.records]
        started = any("seqdb upload to cuda:0 started" in m for m in msgs)
        took = any("took the stage-0 seqdb planes" in m for m in msgs)
        assert started == took == (dev == "cuda"), msgs
    for f in ("shmr-L2-01-of-01.dat", "shmr-L2-MC-01-of-01.dat"):
        assert filecmp.cmp(str(tmp_path / "cuda" / "1-index" / f),
                           str(tmp_path / "cpu" / "1-index" / f),
                           shallow=False), f
