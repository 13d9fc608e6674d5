"""Packed sequence database (seqdb) — vectorized codec + reference-compatible files.

The on-disk format is byte-compatible with the reference assembler so outputs
can be cross-validated:

* ``<prefix>.seqdb`` — one byte per base, 4-bit dual-strand code: the low
  nibble holds the forward base at position ``p``, the high nibble holds the
  complement of the base at the mirrored position ``len-1-p``; decoding the
  same bytes through the high nibble yields the reverse complement
  (reference: src/shmr_utils.c:18-62).
* ``<prefix>.idx`` — text rows ``%09d name len offset``
  (reference: src/shmr_mkseqdb.c:112).

Unlike the reference (pointer-chasing over an mmap), the in-memory form here
is a dense numpy byte array plus offset/length tables, from which padded
2-bit code batches are materialized for the TPU sketch kernel.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

import numpy as np

ORIGINAL = 0
REVERSED = 1

# 4-bit one-hot base codes: A=1 C=2 G=4 T=8, anything else 0 ("N").
_F4 = np.zeros(256, dtype=np.uint8)
_R4 = np.zeros(256, dtype=np.uint8)
for _b, _f, _r in (("A", 1, 8), ("C", 2, 4), ("G", 4, 2), ("T", 8, 1)):
    _F4[ord(_b)] = _F4[ord(_b.lower())] = _f
    _R4[ord(_b)] = _R4[ord(_b.lower())] = _r

# nibble -> ASCII base (reference bits_to_base, src/shmr_utils.c:53)
_BITS2BASE = np.frombuffer(b"NACNGNNNTNNNNNNN", dtype=np.uint8).copy()

# nibble -> 2-bit code (A=0 C=1 G=2 T=3, N=4) for the sketch kernel
_NIB2CODE = np.full(16, 4, dtype=np.uint8)
for _nib, _code in ((1, 0), (2, 1), (4, 2), (8, 3)):
    _NIB2CODE[_nib] = _code

# ASCII -> 2-bit code (minimap2 seq_nt4_table semantics, src/mm_sketch.c:10)
_NT4 = np.full(256, 4, dtype=np.uint8)
for _b, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _NT4[ord(_b)] = _NT4[ord(_b.lower())] = _c

_CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_biseq(seq_bytes: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> 4-bit dual-strand packed bytes (vectorized)."""
    s = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(
        seq_bytes, (bytes, bytearray)) else np.asarray(seq_bytes, dtype=np.uint8)
    return (_R4[s[::-1]] << 4) | _F4[s]


def decode_biseq(packed: np.ndarray | bytes, strand: int = ORIGINAL) -> bytes:
    """Packed bytes -> ASCII sequence; REVERSED yields the reverse complement."""
    p = np.frombuffer(packed, dtype=np.uint8) if isinstance(
        packed, (bytes, bytearray, memoryview)) else np.asarray(packed, dtype=np.uint8)
    nib = (p & 0x0F) if strand == ORIGINAL else (p >> 4)
    return _BITS2BASE[nib].tobytes()


def packed_to_codes(packed: np.ndarray, strand: int = ORIGINAL) -> np.ndarray:
    """Packed bytes -> 2-bit codes (0..3, N=4) on the requested strand."""
    p = np.asarray(packed, dtype=np.uint8)
    nib = (p & 0x0F) if strand == ORIGINAL else (p >> 4)
    return _NIB2CODE[nib]


def seq_to_codes(seq_bytes: bytes) -> np.ndarray:
    return _NT4[np.frombuffer(seq_bytes, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> bytes:
    return _CODE2BASE[np.minimum(codes, 4)].tobytes()


def revcomp(seq: bytes) -> bytes:
    tr = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
    return seq.translate(tr)[::-1]


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return io.BufferedReader(gzip.open(path, "rb"))
    return open(path, "rb")


def read_fastx(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (name, sequence) from FASTA or FASTQ, optionally gzipped.

    Follows kseq semantics (reference: src/kseq.h:100-223): a record starts
    at '>' or '@'; sequence spans every following line until the next
    '>'/'@'/'+'; a '+' introduces quality lines, consumed until their
    accumulated length reaches the sequence length (so quality lines that
    happen to start with '@' or '>' cannot be mistaken for headers).
    Handles wrapped (multi-line) sequence and quality in both formats.
    """
    with _open_maybe_gz(path) as f:
        line = f.readline()
        while line and line[:1] not in (b">", b"@"):
            line = f.readline()  # skip leading junk, as kseq does
        while line:
            name = line[1:].split()[0].decode() if line[1:].split() else ""
            chunks: list[bytes] = []
            line = f.readline()
            while line and line[:1] not in (b">", b"@", b"+"):
                s = line.strip()
                if s:
                    chunks.append(s)
                line = f.readline()
            seq = b"".join(chunks)
            if line[:1] == b"+":  # FASTQ quality block
                qlen = 0
                while qlen < len(seq):
                    qline = f.readline()
                    if not qline:
                        break
                    qlen += len(qline.strip())
                line = f.readline()
            yield name, seq


@dataclass
class SeqDB:
    """Dense packed sequence store with reference-compatible (de)serialization."""

    data: np.ndarray                 # concatenated 4-bit dual-strand bytes
    offsets: np.ndarray              # int64 [n]
    lengths: np.ndarray              # int64 [n]
    names: list[str] = field(default_factory=list)

    # ----- construction -------------------------------------------------
    @classmethod
    def from_reads(cls, reads: Iterable[tuple[str, bytes]]) -> "SeqDB":
        if not isinstance(reads, (list, tuple)):
            reads = list(reads)
        names = [name for name, _ in reads]
        lens = np.array([len(seq) for _, seq in reads], np.int64)
        offs = np.zeros(len(reads), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        # single preallocation + native one-pass per-read encode
        # (encode.cpp) — no per-read temporaries, no final concatenate
        from ..native import encode_biseq_into
        data = np.empty(int(lens.sum()), dtype=np.uint8)
        for (name, seq), off, ln in zip(reads, offs, lens):
            encode_biseq_into(seq, data[off:off + ln])
        return cls(data, offs, lens, names)

    @classmethod
    def from_file_list(cls, list_path: str) -> "SeqDB":
        """Build from a list-of-files manifest (reference shmr_mkseqdb -d)."""
        def gen():
            with open(list_path) as f:
                for line in f:
                    p = line.strip()
                    if p:
                        yield from read_fastx(p)
        return cls.from_reads(gen())

    @classmethod
    def build_to_disk(cls, list_path: str, prefix: str,
                      progress=None, chunk_sink=None,
                      chunk_bases: int = 1 << 22,
                      use_native: bool = True) -> "SeqDB":
        """Stream-encode a read manifest straight to <prefix>.seqdb/.idx.

        Peak anonymous RSS is bounded by one read + the write buffer
        instead of the whole packed array (the reference builds its seqdb
        the same way — shmr_mkseqdb encodes and writes per read,
        src/shmr_mkseqdb.c:83-118; a human-30x dataset is ~90 GB packed
        and cannot be materialized).  Returns the reopened database as a
        read-only memmap, so downstream stages read through the page
        cache under OS memory pressure control.

        With use_native (default), each manifest file is parsed AND
        encoded by the C++ streamer (native/fastx.cpp, ~5x the Python
        readline loop which capped stage 0 at ~90 MB/s); the Python loop
        below is the kseq-semantics oracle (byte-identity asserted in
        tests/test_seqdb.py).  chunk_sink then feeds from a page-cache
        re-read of the freshly written region."""
        if use_native:
            return cls._build_to_disk_native(list_path, prefix, progress,
                                             chunk_sink)

        def gen():
            with open(list_path) as lf:
                for line in lf:
                    path = line.strip()
                    if path:
                        yield from read_fastx(path)
        return cls.build_to_disk_from_iter(gen(), prefix, progress=progress,
                                           chunk_sink=chunk_sink,
                                           chunk_bases=chunk_bases)

    @classmethod
    def build_to_disk_from_iter(cls, reads: Iterable[tuple[str, bytes]],
                                prefix: str, progress=None, chunk_sink=None,
                                chunk_bases: int = 1 << 22) -> "SeqDB":
        """Stream-encode an in-process (name, seq) iterator straight to
        <prefix>.seqdb/.idx — same bounded-RSS contract as
        build_to_disk, without a FASTA on disk.  Used by the scale
        harness to simulate human-class read sets (a 90 GB FASTA +
        90 GB seqdb would not fit the node's disk together)."""
        from ..native import encode_biseq_into
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        buf = np.empty(1 << 22, np.uint8)
        off = 0
        rid = 0
        # chunk_sink (e.g. ops.dbgather.SeqDBUploader.feed) receives the
        # encoded stream as it is produced, in pieces cut at 1024-base
        # multiples — the device upload then overlaps the encode wall
        pend: list = []
        pend_n = 0

        def _flush_sink(final: bool) -> None:
            nonlocal pend, pend_n
            cat = np.concatenate(pend) if len(pend) > 1 else pend[0]
            cut = len(cat) if final else (len(cat) // 1024) * 1024
            if cut:
                chunk_sink(cat[:cut])
            pend = [cat[cut:]] if cut < len(cat) else []
            pend_n = len(cat) - cut

        with open(prefix + ".seqdb.tmp", "wb", buffering=1 << 22) as fd, \
                open(prefix + ".idx.tmp", "w") as fi:
            for name, seq in reads:
                ln = len(seq)
                if ln > len(buf):
                    buf = np.empty(ln, np.uint8)
                encode_biseq_into(seq, buf[:ln])
                fd.write(memoryview(buf[:ln]))
                if chunk_sink is not None:
                    pend.append(buf[:ln].copy())
                    pend_n += ln
                    if pend_n >= chunk_bases:
                        _flush_sink(final=False)
                fi.write(f"{rid:09d} {name} {ln} {off}\n")
                off += ln
                rid += 1
                if progress is not None and rid % 100000 == 0:
                    progress(rid, off)
            if chunk_sink is not None and pend:
                _flush_sink(final=True)
        # .seqdb lands before .idx — resume trusts .idx, so a crash
        # between the renames cannot yield a checkpoint with a short
        # data file
        os.replace(prefix + ".seqdb.tmp", prefix + ".seqdb")
        os.replace(prefix + ".idx.tmp", prefix + ".idx")
        return cls.open(prefix)

    @classmethod
    def _build_to_disk_native(cls, list_path: str, prefix: str,
                              progress=None, chunk_sink=None) -> "SeqDB":
        from ..native import fastx_encode_append
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        tmp = prefix + ".seqdb.tmp"
        open(tmp, "wb").close()  # truncate; native appends per file
        off = 0
        rid = 0

        # the native parse releases the GIL, so a feeder thread tails the
        # growing file and hands 1024-aligned chunks to the sink while
        # parsing continues (a per-file hand-off would defer the whole
        # upload to EOF for single-file manifests)
        import threading
        import time as _time
        fed = [0]
        stop = threading.Event()

        def _feed(limit: int) -> None:
            cut = ((limit - fed[0]) // 1024) * 1024
            if cut <= 0:
                return
            mm = np.memmap(tmp, dtype=np.uint8, mode="r")
            chunk_sink(np.asarray(mm[fed[0]:fed[0] + cut]))
            del mm
            fed[0] += cut

        def _feeder():
            while not stop.is_set():
                try:
                    size = os.path.getsize(tmp)
                except OSError:
                    size = 0
                if size - fed[0] >= 1 << 22:
                    _feed(size)
                else:
                    _time.sleep(0.2)

        feeder = None
        if chunk_sink is not None:
            feeder = threading.Thread(target=_feeder, name="seqdb-feed")
            feeder.start()
        try:
            with open(prefix + ".idx.tmp", "w") as fi, open(list_path) as lf:
                for line in lf:
                    path = line.strip()
                    if not path:
                        continue
                    names, lens, _total = fastx_encode_append(path, tmp)
                    rows = []
                    for name, ln in zip(names, lens.tolist()):
                        rows.append(f"{rid:09d} {name} {ln} {off}\n")
                        off += ln
                        rid += 1
                    fi.write("".join(rows))
                    if progress is not None:
                        progress(rid, off)
        finally:
            if feeder is not None:
                stop.set()
                feeder.join()
        if chunk_sink is not None and off > fed[0]:
            mm = np.memmap(tmp, dtype=np.uint8, mode="r")
            chunk_sink(np.asarray(mm[fed[0]:off]))
            del mm
        os.replace(tmp, prefix + ".seqdb")
        os.replace(prefix + ".idx.tmp", prefix + ".idx")
        return cls.open(prefix)

    @classmethod
    def open(cls, prefix: str) -> "SeqDB":
        names, offs, lens = [], [], []
        with open(prefix + ".idx") as f:
            for row in f:
                parts = row.split()
                if len(parts) < 4:
                    continue
                names.append(parts[1])
                lens.append(int(parts[2]))
                offs.append(int(parts[3]))
        # read-only mmap: the reference's shared data plane (every worker
        # mmaps the same .seqdb, src/shmr_overlap.c:200) — opening costs
        # nothing and spawn workers share the page cache instead of each
        # copying the whole file
        data = np.memmap(prefix + ".seqdb", dtype=np.uint8, mode="r")
        return cls(data, np.asarray(offs, np.int64), np.asarray(lens, np.int64), names)

    def save(self, prefix: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        self.data.tofile(prefix + ".seqdb")
        with open(prefix + ".idx", "w") as f:
            for rid in range(len(self)):
                f.write(f"{rid:09d} {self.names[rid]} "
                        f"{int(self.lengths[rid])} {int(self.offsets[rid])}\n")

    # ----- access -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.lengths)

    def packed(self, rid: int) -> np.ndarray:
        o, l = int(self.offsets[rid]), int(self.lengths[rid])
        return self.data[o:o + l]

    def seq(self, rid: int, strand: int = ORIGINAL) -> bytes:
        return decode_biseq(self.packed(rid), strand)

    def codes(self, rid: int, strand: int = ORIGINAL) -> np.ndarray:
        return packed_to_codes(self.packed(rid), strand)

    def padded_code_batch(self, rids: Sequence[int], pad_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Materialize [B, pad_len] 2-bit code batch (pad value 4 = invalid).

        Returns (codes, lengths); reads longer than pad_len are rejected.
        """
        batch = np.full((len(rids), pad_len), 4, dtype=np.uint8)
        lens = np.zeros(len(rids), dtype=np.int32)
        for i, rid in enumerate(rids):
            c = self.codes(rid)
            if len(c) > pad_len:
                raise ValueError(f"read {rid} length {len(c)} > pad_len {pad_len}")
            batch[i, :len(c)] = c
            lens[i] = len(c)
        return batch, lens

    def write_fasta(self, path: str) -> None:
        with open(path, "w") as f:
            for rid in range(len(self)):
                f.write(f">{self.names[rid]}\n{self.seq(rid).decode()}\n")
