"""SHIMMER chain alignment — greedy co-linear chaining of shared minimizers.

A copy of peregrine_tpu/ops/chain.py (host code; unchanged).

Re-implementation of the reference's cffi-only chain aligner
(src/shmr_align.c:21-160): hits between two minimizer lists are appended to
the existing chain with the closest offset consistency (|delta0 - delta1| <
max_diff, positional gap < max_dist), else start a new chain.

The reference indexes the reversed second list as ``n - ss`` which reads
one element past the end on the first step; here the reversed walk starts
at ``n - 1 - ss``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_SMALL_ALNS = 4800


@dataclass
class ShimmerChain:
    idx0: list[int] = field(default_factory=list)
    idx1: list[int] = field(default_factory=list)


def _pos(y: int) -> int:
    return (y & 0xFFFFFFFF) >> 1


def shmr_aln(x0: np.ndarray, y0: np.ndarray, x1: np.ndarray, y1: np.ndarray,
             direction: int = 0, max_diff: int = 100, max_dist: int = 1200,
             max_repeat: int = 1) -> list[ShimmerChain]:
    """Chain shared minimizers between two SHIMMER lists."""
    index_of: dict[int, list[int]] = {}
    for s in range(len(x0)):
        index_of.setdefault(int(x0[s]) >> 8, []).append(s)

    chains: list[ShimmerChain] = []
    n1 = len(x1)
    for ss in range(n1):
        s = (n1 - 1 - ss) if direction == 1 else ss
        mhash = int(x1[s]) >> 8
        hits = index_of.get(mhash)
        if hits is None or len(hits) > max_repeat:
            continue
        p1 = _pos(int(y1[s]))
        strand1 = int(y1[s]) & 1
        small = 0
        for i0 in hits:
            strand0 = int(y0[i0]) & 1
            if direction == 0 and strand0 != strand1:
                continue
            if direction == 1 and strand0 == strand1:
                continue
            p0 = _pos(int(y0[i0]))
            delta0 = abs(p0 + p1) if direction == 1 else abs(p0 - p1)

            best_idx = -1
            min_diff = max_diff
            small = 0
            for ci, chain in enumerate(chains):
                if len(chain.idx0) < 3:
                    small += 1
                if i0 < chain.idx0[-1]:
                    continue
                m0p = _pos(int(y0[chain.idx0[-1]]))
                m1p = _pos(int(y1[chain.idx1[-1]]))
                mm_dist = abs(p0 - m0p)
                if mm_dist >= max_dist:
                    continue
                delta1 = abs(m0p + m1p) if direction == 1 else abs(m0p - m1p)
                diff = abs(delta0 - delta1)
                if diff < max_diff and diff < min_diff:
                    min_diff = diff
                    best_idx = ci
            if best_idx >= 0:
                chains[best_idx].idx0.append(i0)
                chains[best_idx].idx1.append(s)
            else:
                chains.append(ShimmerChain([i0], [s]))
        if small > MAX_SMALL_ALNS:
            break
    return chains
