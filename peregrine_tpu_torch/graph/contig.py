"""Draft contig sequences from tiling paths
(reference py/scripts/path_to_contig.py).

The first read of each path seeds the contig; every subsequent edge
contributes its read segment, spliced at a stitch point found by aligning a
500 bp overhang of the running contig tail against the incoming read with
the banded O(ND) kernel.
"""

from __future__ import annotations

import numpy as np

from ..io.seqdb import SeqDB, decode_biseq
from ..native import ovlp_match

STITCH_OVERHANG = 500


def tiling_to_contigs(db: SeqDB, tiling_lines) -> list[tuple[str, bytes]]:
    """Tiling-path rows -> [(ctg_id, sequence)]
    (reference path_to_contig.py:11-115)."""
    by_ctg: dict[str, list[list[str]]] = {}
    for line in tiling_lines:
        f = line.split()
        if f:
            by_ctg.setdefault(f[0], []).append(f)

    contigs = []
    for ctg, rows in by_ctg.items():
        ctg_id, v, w, r, s, e, olen, idt, _1, _2 = rows[0]
        rid0, end0 = v.split(":")
        rid0 = int(rid0)
        strand0 = 0 if end0 == "E" else 1
        bseq0 = db.packed(rid0)
        seq = decode_biseq(bseq0, strand0)
        ctg_len = len(seq)
        segments = [(ctg_len, 0, seq)]

        for row in rows:
            ctg_id, v, w, r, s, e, olen, idt, _1, _2 = row
            rid0, end0 = v.split(":")
            rid0 = int(rid0)
            strand0 = 0 if end0 == "E" else 1
            rid1, end1 = w.split(":")
            rid1 = int(rid1)
            strand1 = 0 if end1 == "E" else 1
            s, e = int(s), int(e)

            slen0 = int(db.lengths[rid0])
            slen1 = int(db.lengths[rid1])
            bseq0 = db.packed(rid0)
            bseq1 = db.packed(rid1)

            off1 = slen0 - STITCH_OVERHANG
            off2 = slen1 - abs(e - s) - STITCH_OVERHANG
            m = ovlp_match(bseq0[off1:].tobytes(), strand0,
                           bseq1[off2:].tobytes(), strand1, 100)

            if strand1 == 1:
                s, e = slen1 - s, slen1 - e
            assert e > s
            seg_size = e - s + STITCH_OVERHANG - m.t_m_end
            seg = decode_biseq(bseq1[e - seg_size:e], strand1)
            segments.append((ctg_len,
                             ctg_len - STITCH_OVERHANG + m.q_m_end,
                             seg))
            ctg_len -= STITCH_OVERHANG - m.q_m_end
            ctg_len += (STITCH_OVERHANG - m.t_m_end) + e - s

        canvas = np.full(ctg_len, ord("N"), dtype=np.uint8)
        for _, start, sseq in segments:
            canvas[start:start + len(sseq)] = np.frombuffer(sseq, np.uint8)
        contigs.append((ctg, canvas.tobytes()))
    return contigs
