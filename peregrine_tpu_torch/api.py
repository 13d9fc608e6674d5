"""High-level sequence API (equivalent of the reference's
py/peregrine/utils.py over the cffi modules).

The port of peregrine_tpu/api.py: entry points for sketching single
sequences, chaining SHIMMERs between sequences, tagging alignments, and
ad-hoc read-cluster consensus.  The functions that sketch take a device
(default cuda, no fallback): the sketch and its reduction levels run the
SHIMMER kernels there; chaining, alignment and the pileup are host code.
"""

from __future__ import annotations

import numpy as np

from .io.seqdb import revcomp, seq_to_codes
from .native import dw_align
from .ops.chain import shmr_aln
from .ops.consensus import cns_from_tags, get_align_tags
from .ops.kernels import require_device
from .ops.reduce import reduce_flat_np
from .ops.sketch import sketch_reads_np


def mmer2tuple(x: int, y: int):
    """(hash, span, rid, pos_end, strand) view of a SHIMMER record
    (reference py/peregrine/utils.py:17-25)."""
    return (x >> 8, x & 0xFF, y >> 32, ((y & 0xFFFFFFFF) >> 1) + 1, y & 1)


def get_shimmers_from_seq(seq: bytes, rid: int = 0, levels: int = 2,
                          reduction_factor: int = 3, k: int = 16,
                          w: int = 80, device="cuda"
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Sketch one sequence to the requested SHIMMER level (0 returns the
    sketch itself) on `device`; returns uint64 (x, y)."""
    if levels > 2:
        raise ValueError(f"levels={levels}: at most 2 reduction levels")
    device = require_device(device)
    # the chunked kernels take any row length; 64 is the reference's floor
    pad = max(64, len(seq))
    codes = np.full((1, pad), 4, np.uint8)
    codes[0, :len(seq)] = seq_to_codes(seq)
    x, y = sketch_reads_np(codes, np.array([len(seq)], np.int32),
                           np.array([rid], np.int64), w, k, device)
    for _ in range(levels):
        x, y = reduce_flat_np(x, y, reduction_factor, device)
    return x, y


def get_shimmer_alns(sh0, sh1, direction: int = 0, max_diff: int = 100,
                     max_dist: int = 1200, max_repeat: int = 1):
    """Chain shared SHIMMERs; returns [(chain, max_off, mean_off, min_off)]
    with chain = [(mmer0_tuple, mmer1_tuple), ...]
    (reference py/peregrine/utils.py:52-73)."""
    x0, y0 = sh0
    x1, y1 = sh1
    chains = shmr_aln(x0, y0, x1, y1, direction, max_diff, max_dist, max_repeat)
    out = []
    for ch in chains:
        tuples = []
        offsets = []
        for i0, i1 in zip(ch.idx0, ch.idx1):
            m0 = mmer2tuple(int(x0[i0]), int(y0[i0]))
            m1 = mmer2tuple(int(x1[i1]), int(y1[i1]))
            tuples.append((m0, m1))
            offsets.append(m0[3] - m1[3] if direction == 0 else m0[3] + m1[3])
        out.append((tuples, max(offsets), float(np.mean(offsets)), min(offsets)))
    return out


def get_tag_from_seqs(read_seq: bytes, ref_seq: bytes, read_offset: int,
                      band: int = 150, fuzz: int = 48):
    """Align a read to a template and return its pileup tags, or None when
    the alignment endpoints disqualify it (reference utils.py:76-122)."""
    read_len, ref_len = len(read_seq), len(ref_seq)
    if read_offset < 0:
        aln = dw_align(read_seq[-read_offset:], ref_seq, band)
        if abs(abs(aln.aln_q_e - aln.aln_q_s) - (read_len + read_offset)) < fuzz:
            return get_align_tags(aln.q_aln_str, aln.t_aln_str,
                                  aln.aln_q_s, aln.aln_t_s, 0)
        return None
    aln = dw_align(read_seq, ref_seq[read_offset:], band)
    if (abs(abs(aln.aln_q_e - aln.aln_q_s) - read_len) < fuzz
            or abs(ref_len - read_offset - abs(aln.aln_q_e - aln.aln_q_s)) < fuzz):
        return get_align_tags(aln.q_aln_str, aln.t_aln_str,
                              aln.aln_q_s, aln.aln_t_s, read_offset)
    return None


def get_cns_from_reads(seqs: list[bytes], levels: int = 2,
                       min_cov: int = 1, device="cuda") -> bytes:
    """Consensus of a read cluster: the first read is the backbone; every
    other read (both strands) is chained to locate its offset, aligned, and
    piled up (reference utils.py:125-181; note the reference's forward-strand
    branch re-aligns the backbone to itself — utils.py:150-151 — which this
    implementation corrects by aligning the actual read).  The sketches run
    on `device`."""
    device = require_device(device)
    seq0 = seqs[0]
    sh0 = get_shimmers_from_seq(seq0, rid=0, levels=levels, device=device)
    tags = []
    t = get_tag_from_seqs(seq0, seq0, 0)
    if t is not None:
        tags.append(t)
    for i, seq in enumerate(seqs[1:], start=1):
        for strand, s in ((0, seq), (1, revcomp(seq))):
            sh1 = get_shimmers_from_seq(s, rid=i * 2 + strand, levels=levels,
                                        device=device)
            alns = get_shimmer_alns(sh0, sh1, 0)
            if not alns:
                continue
            alns.sort(key=lambda a: -len(a[0]))
            chain = alns[0][0]
            read_offset = chain[0][0][3] - chain[0][1][3]
            tag = get_tag_from_seqs(s, seq0, read_offset)
            if tag is not None:
                tags.append(tag)
    return cns_from_tags(tags, len(seq0), min_cov)
