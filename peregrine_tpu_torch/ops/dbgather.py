"""Device-resident seqdb: 2-bit packed upload + window gather.

The port of peregrine_tpu/ops/dbgather.py (see its docstring for the
packed layout).  The seqdb lives on the device as two uint8 planes:

  * fw:  2-bit forward base codes, 4 bases/byte, [rows, 128];
  * amb: 1-bit ambiguity flags (non-ACGT), 8 bases/byte, [rows, 128];

both with GUARD_BASES of zeros before the first base, so mirrored
strand-1 window starts stay in bounds.  The planes are byte-identical to
the JAX package's.  They reach the device through SeqDBUploader, which
packs and copies on a worker thread: stage 0 feeds it while it encodes,
and upload_seqdb feeds it a whole seqdb at once.  gather_codes
(ops/kernels.py, re-exported here) launches pg_gather_codes
(csrc/shimmer_kernels.cu) on planes on a CUDA card, one thread per 16
output bases; on planes on the CPU it runs gather_codes_plain, plain
tensor indexing.  The TPU's whole-row gather with its shift-select ladder
is a workaround for slow element gathers that neither needs.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

# GUARD_BASES: the guard (in bases) below the packed db start; the
# gather's wrapper and plain version live with the other kernels
from .kernels import GUARD_BASES, gather_codes, gather_codes_plain  # noqa: F401


class PackedSeqDB(NamedTuple):
    """Two-plane packed seqdb on one device."""
    fw: torch.Tensor    # [Rf, 128] uint8 — 2-bit codes, 4 bases/byte
    amb: torch.Tensor   # [Ra, 128] uint8 — ambiguity bits, 8 bases/byte


def pack_db_np(data: np.ndarray, guard_bases: int = GUARD_BASES
               ) -> tuple[np.ndarray, np.ndarray]:
    """Host packing: 4-bit codec bytes -> (fw bytes, amb bytes) with the
    guard region prepended (one C++ pass, native/pack2.cpp)."""
    assert guard_bases % 1024 == 0
    from ..native import pack_db
    return pack_db(data, guard_bases)


def _rows_class(nbytes: int, floor_rows: int) -> int:
    """The row count of a plane of `nbytes` bytes: pow2 with 3 mantissa
    bits (<= 8 shape classes per octave) above floor_rows — the JAX
    package's shape classes, kept so both packages hold the same planes."""
    n_rows = max(1, -(-nbytes // 128))
    if n_rows <= floor_rows:
        return floor_rows
    unit = max(floor_rows, 1 << max(0, (n_rows - 1).bit_length() - 3))
    return -(-n_rows // unit) * unit


def _pad_rows(flat: np.ndarray, floor_rows: int) -> np.ndarray:
    """[N] bytes -> [rows, 128], zero-padded to _rows_class's rows."""
    rows = np.zeros((_rows_class(len(flat), floor_rows), 128), np.uint8)
    rows.reshape(-1)[:len(flat)] = flat
    return rows


def packed_from_numpy(fw: np.ndarray, amb: np.ndarray, device) -> PackedSeqDB:
    """A PackedSeqDB from numpy planes (e.g. the JAX package's planes)."""
    def put(a):
        return torch.from_numpy(np.require(a, np.uint8, ["C", "W"])).to(device)
    return PackedSeqDB(fw=put(fw), amb=put(amb))


# each plane's floor row count and bases a byte
_PLANES = {"fw": (1 << 19, 4), "amb": (1 << 17, 8)}
# the stats of the last uploader that finished (upload_seqdb's included)
LAST_STATS: dict = {}


def upload_seqdb(data: np.ndarray, device) -> PackedSeqDB:
    """Pack the 4-bit seqdb bytes and move both planes to `device`,
    through SeqDBUploader (pack, staging buffer, copy): an amb plane whose
    bytes are all zero is made on the device, not copied.  `data` is read
    in place and must not change before this returns."""
    data = np.asarray(data)
    up = SeqDBUploader(device, est_bases=len(data))
    up.feed(data)
    return up.finish()


class SeqDBUploader:
    """Incremental pack and upload of the 4-bit seqdb bytes while the host
    still produces them: the port of the JAX package's SeqDBUploader,
    which hides the pack and the copy under stage 0's encode.

    feed() takes consecutive codec bytes, every chunk but the last a
    multiple of CHUNK_ALIGN bases, so that each chunk's bytes start on a
    whole byte of both planes.  A worker thread packs each chunk with
    pack_db_np (the first with the GUARD_BASES guard, the later ones with
    none), in parts of PACK_SPLIT bases on PACK_THREADS threads, and
    copies its bytes into one of N_STAGING staging buffers (pinned on a
    card).  When a buffer holds a piece (PIECE_FW_BYTES fw bytes and half
    as many amb bytes), the piece goes to its offset in the device planes
    by non_blocking copies on a stream of the uploader's own.  Each buffer
    has an event, which the worker waits on before it fills the buffer
    again.  An amb piece whose bytes are all zero is not copied: the amb
    plane is made as device zeros at the first piece that is not, or at
    finish() where there is none.

    The worker selects the device before its first CUDA call.  The planes
    are allocated on the consumer's stream (the one current where the
    uploader was made) and recorded on the uploader's: at the shape class
    of est_bases (the bases expected), grown where the data outruns them,
    and cut to the data's class at the end, the zero padding made on the
    device.  finish() joins the worker, raises its
    error (a ragged chunk that was not the last is one), makes the
    caller's current stream wait for the last copy and returns a
    PackedSeqDB equal to the one-shot pack of the data, byte for byte and
    in shape.  On the CPU the same steps run with CPU tensors.  `stats`
    holds the worker's split of its time and the bytes it moved."""

    CHUNK_ALIGN = 1024
    # fw bytes a piece: the pinned copy rate on the card has flattened
    # out by this size (scripts/torch_upload_pieces.py)
    PIECE_FW_BYTES = 8 << 20
    N_STAGING = 3
    # a chunk is packed in parts of PACK_SPLIT bases (a multiple of
    # CHUNK_ALIGN), PACK_THREADS at once: the pack (one byte a base, in
    # native code that releases the GIL) is the upload's cost
    PACK_SPLIT = 1 << 22
    PACK_THREADS = 4

    def __init__(self, device, est_bases: int = 0):
        import queue
        import threading
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._consumer = torch.cuda.current_stream(self.device)
        self.est_bases = int(est_bases)
        self._piece = self.PIECE_FW_BYTES
        assert self._piece >= 256 and self._piece % 2 == 0
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._first = True
        self._t0 = None
        self._err: BaseException | None = None
        self._dev: dict = {"fw": None, "amb": None}
        self._done = None
        self.stats = dict(bases=0, chunks=0, pieces=0, init_s=0.0,
                          pack_s=0.0, stage_s=0.0, wait_s=0.0, alloc_s=0.0,
                          copied_bytes=0, elided_bytes=0, pad_bytes=0,
                          peak_plane_bytes=0, feed_to_finish_s=0.0)
        self._t = threading.Thread(target=self._worker, name="seqdb-upload",
                                   daemon=True)
        self._t.start()

    # --- the caller's side ---------------------------------------------
    def feed(self, chunk: np.ndarray) -> None:
        """chunk: consecutive 4-bit codec bytes; every call except the
        last must pass a multiple of CHUNK_ALIGN bases.  The chunk is read
        in place, so it must not change until finish() returns (each of
        build_to_disk's routes hands over a fresh array or a read-only
        map of the written file)."""
        chunk = np.asarray(chunk, np.uint8)
        if len(chunk) == 0:
            return
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self.stats["bases"] += len(chunk)
        self._q.put((chunk, self._first))
        self._first = False

    def finish(self) -> PackedSeqDB:
        """Join the worker and return the planes (see the class)."""
        self._q.put(None)
        self._t.join()
        st = self.stats
        if self._err is not None:
            raise self._err
        fw, amb = self._dev["fw"], self._dev["amb"]
        if self._first:  # nothing fed: the guard alone, all zeros
            fw = torch.zeros((_PLANES["fw"][0], 128), dtype=torch.uint8,
                             device=self.device)
            st["pad_bytes"] = fw.numel() - GUARD_BASES // 4
        if amb is None:  # no ambiguous base
            amb_bytes = -(-(GUARD_BASES + st["bases"]) // 8)
            amb = torch.zeros((_rows_class(amb_bytes, _PLANES["amb"][0]), 128),
                              dtype=torch.uint8, device=self.device)
            st["pad_bytes"] += amb.numel() - amb_bytes
            st["peak_plane_bytes"] = max(st["peak_plane_bytes"],
                                         fw.numel() + amb.numel())
        if self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)
        if self._t0 is not None:
            st["feed_to_finish_s"] = time.perf_counter() - self._t0
        self._dev = {"fw": None, "amb": None}
        self._host = self._host_np = None
        LAST_STATS.clear()
        LAST_STATS.update(st)
        return PackedSeqDB(fw=fw, amb=amb)

    # --- the worker ------------------------------------------------------
    def _worker(self) -> None:
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(self.PACK_THREADS,
                                        thread_name_prefix="seqdb-pack")
        try:
            self._open()
        except BaseException as e:  # surfaced by finish()
            self._err = e
        fed = False
        while True:
            item = self._q.get()
            if item is None:
                break
            fed = True
            if self._err is None:
                try:
                    self._take(*item)
                except BaseException as e:
                    self._err = e
        self._pool.shutdown()
        if fed and self._err is None:
            try:
                self._close()
            except BaseException as e:
                self._err = e

    def _open(self) -> None:
        """Select the device, then make the stream, the staging buffers
        and their events, and the fw plane at est_bases's class."""
        t = time.perf_counter()
        if self._cuda:
            torch.cuda.set_device(self.device)
            self._side = torch.cuda.Stream(self.device)
            self._events = [torch.cuda.Event() for _ in range(self.N_STAGING)]
        self._host = [tuple(torch.empty(n, dtype=torch.uint8,
                                        pin_memory=self._cuda)
                            for n in (self._piece, self._piece // 2))
                      for _ in range(self.N_STAGING)]
        self._host_np = [(a.numpy(), b.numpy()) for a, b in self._host]
        self._used = [False] * self.N_STAGING
        self._slot = 0
        self._fill = [0, 0]   # fw, amb bytes in the current buffer
        self._off = [0, 0]    # the planes' byte offsets of that buffer
        self._ragged = 0
        self.stats["init_s"] = time.perf_counter() - t
        self._plane("fw", 0)

    def _side_stream(self):
        return (torch.cuda.stream(self._side) if self._cuda
                else contextlib.nullcontext())

    def _plane(self, name: str, need: int) -> torch.Tensor:
        """The `name` plane, holding at least `need` bytes; where it does
        not, a new one at the class of est_bases, or of twice the old
        plane, with the old bytes copied over (amb is zeroed first)."""
        cur = self._dev[name]
        if cur is not None and cur.numel() >= need:
            return cur
        t = time.perf_counter()
        floor, per = _PLANES[name]
        est = -(-(GUARD_BASES + self.est_bases) // per)
        old = cur.numel() if cur is not None else 0
        new = self._alloc(_rows_class(max(need, est, 2 * old), floor))
        with self._side_stream():
            if name == "amb":
                new.zero_()
            if cur is not None:
                new.view(-1)[:old].copy_(cur.view(-1))
        self._dev[name] = new
        live = sum(p.numel() for p in self._dev.values() if p is not None)
        self.stats["peak_plane_bytes"] = max(self.stats["peak_plane_bytes"],
                                             live + old)
        self.stats["alloc_s"] += time.perf_counter() - t
        return new

    def _alloc(self, rows: int) -> torch.Tensor:
        """[rows, 128] uint8 on the device, allocated on the consumer's
        stream and recorded on the uploader's, which first waits for the
        consumer's work so far (an earlier user of the memory)."""
        if not self._cuda:
            return torch.empty((rows, 128), dtype=torch.uint8)
        with torch.cuda.stream(self._consumer):
            t = torch.empty((rows, 128), dtype=torch.uint8, device=self.device)
        t.record_stream(self._side)
        self._side.wait_stream(self._consumer)
        return t

    def _take(self, chunk: np.ndarray, first: bool) -> None:
        """Pack one chunk into the staging buffers, flushing full ones."""
        if self._ragged:
            raise ValueError(
                f"seqdb uploader: a chunk of {self._ragged} bases (not a "
                f"multiple of {self.CHUNK_ALIGN}) was followed by another; "
                "only the last chunk may be ragged")
        if len(chunk) % self.CHUNK_ALIGN:
            self._ragged = len(chunk)
        self.stats["chunks"] += 1
        step = self.PACK_SPLIT
        starts = list(range(0, len(chunk), step))
        for j in range(0, len(starts), self.PACK_THREADS):
            t = time.perf_counter()
            parts = list(self._pool.map(lambda i: pack_db_np(
                chunk[i:i + step], GUARD_BASES if first and i == 0 else 0),
                starts[j:j + self.PACK_THREADS]))
            self.stats["pack_s"] += time.perf_counter() - t
            for src in parts:
                self._stage(src)

    def _stage(self, src: tuple) -> None:
        """Copy packed (fw, amb) bytes into the staging buffers, flushing
        each one that fills."""
        t1 = time.perf_counter()
        done = [0, 0]
        while done[0] < len(src[0]) or done[1] < len(src[1]):
            bufs = self._host_np[self._slot]
            full = False
            for p in (0, 1):
                a, f = done[p], self._fill[p]
                n = min(len(src[p]) - a, len(bufs[p]) - f)
                bufs[p][f:f + n] = src[p][a:a + n]
                done[p], self._fill[p] = a + n, f + n
                full |= f + n == len(bufs[p])
            if full:
                self.stats["stage_s"] += time.perf_counter() - t1
                self._flush()
                t1 = time.perf_counter()
        self.stats["stage_s"] += time.perf_counter() - t1

    def _flush(self) -> None:
        """Copy the current buffer's piece to the planes, and move to the
        next buffer once its last copy has finished."""
        nf, na = self._fill
        if not (nf or na):
            return
        s = self._slot
        hfw, hamb = self._host[s]
        of, oa = self._off
        elide = not self._host_np[s][1][:na].any()
        fw = self._plane("fw", of + nf)
        amb = None if elide else self._plane("amb", oa + na)
        with self._side_stream():
            fw.view(-1)[of:of + nf].copy_(hfw[:nf], non_blocking=True)
            if amb is not None:
                amb.view(-1)[oa:oa + na].copy_(hamb[:na], non_blocking=True)
            if self._cuda:
                self._events[s].record(self._side)
        st = self.stats
        st["pieces"] += 1
        st["copied_bytes"] += nf + (0 if elide else na)
        st["elided_bytes"] += na if elide else 0
        self._used[s] = True
        self._off = [of + nf, oa + na]
        self._fill = [0, 0]
        self._slot = (s + 1) % self.N_STAGING
        if self._cuda and self._used[self._slot]:
            t = time.perf_counter()
            self._events[self._slot].synchronize()
            st["wait_s"] += time.perf_counter() - t

    def _close(self) -> None:
        """The last piece; the planes cut to the data's class, the fw
        padding zeroed on the device; the event finish() waits on."""
        self._flush()
        nf, na = self._off
        fw = self._fit("fw", nf)
        with self._side_stream():
            fw.view(-1)[nf:].zero_()
        self.stats["pad_bytes"] += fw.numel() - nf
        if self._dev["amb"] is not None:
            self.stats["pad_bytes"] += self._fit("amb", na).numel() - na
        if self._cuda:
            self._done = torch.cuda.Event()
            self._done.record(self._side)

    def _fit(self, name: str, nbytes: int) -> torch.Tensor:
        """The `name` plane at the class of nbytes: itself, or a copy of
        its first rows where it was allocated larger."""
        cur = self._plane(name, nbytes)
        rows = _rows_class(nbytes, _PLANES[name][0])
        if cur.shape[0] != rows:
            t = time.perf_counter()
            new = self._alloc(rows)
            with self._side_stream():
                new.copy_(cur[:rows])
            live = sum(p.numel() for p in self._dev.values() if p is not None)
            self.stats["peak_plane_bytes"] = max(
                self.stats["peak_plane_bytes"], live + new.numel())
            self._dev[name] = new
            self.stats["alloc_s"] += time.perf_counter() - t
        return self._dev[name]


def gather_offsets(off: np.ndarray, lens: np.ndarray, strand: np.ndarray,
                   read_start: np.ndarray, L: int):
    """Host helper: gather start per request.  strand 0 -> window start;
    strand 1 -> mirrored start (windows must end at their read's end)."""
    return np.where(strand == 0, off, read_start + lens - L)
