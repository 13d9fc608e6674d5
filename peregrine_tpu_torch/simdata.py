"""Seeded simulated genomes and error-laden long reads (numpy only).

The same generator as tests/simdata.py (random_genome, mutate,
simulate_reads; the same numpy draws, so the same seed gives the same
reads), kept in the port because that module imports the JAX package.
It mirrors the reference test harness's simulator semantics: 1% errors,
uniform sub/del/ins, random strand (test/ecoli_K12/simulate_reads.py).
"""

from __future__ import annotations

import numpy as np

from .io.seqdb import revcomp

_B = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng: np.random.Generator, n: int) -> bytes:
    return _B[rng.integers(0, 4, n)].tobytes()


def mutate(rng: np.random.Generator, seq: bytes, rate: float = 0.01) -> bytes:
    """Vectorized sub/del/ins errors at the given per-base rate."""
    a = np.frombuffer(seq, np.uint8)
    n = len(a)
    hit = rng.random(n) < rate
    choice = rng.integers(0, 9, n)
    # substitutions (choice 0-3)
    out = a.copy()
    sub = hit & (choice < 4)
    out[sub] = _B[choice[sub]]
    # emit lengths: 0 for deletion (choice 4), 2 for insertion (5-8), else 1
    emit = np.ones(n, np.int64)
    emit[hit & (choice == 4)] = 0
    ins = hit & (choice >= 5)
    emit[ins] = 2
    dest = np.cumsum(emit) - emit
    total = int(dest[-1] + emit[-1]) if n else 0
    res = np.empty(total, np.uint8)
    keep = emit > 0
    res[dest[keep]] = out[keep]
    res[dest[ins] + 1] = _B[choice[ins] - 5]
    return res.tobytes()


def simulate_reads(rng: np.random.Generator, genome: bytes, *,
                   read_len: int = 3000, coverage: float = 10.0,
                   len_sd: int = 300, error: float = 0.01,
                   circular_wrap: int = 0):
    """Returns (reads, truth): reads = [(name, seq)], truth = [(start, end, strand)]."""
    g = genome + genome[:circular_wrap]
    n_reads = int(coverage * len(g) / read_len)
    reads, truth = [], []
    for i in range(n_reads):
        rl = max(read_len // 3, int(read_len + rng.normal(0, len_sd)))
        s = int(rng.integers(0, max(1, len(g) - rl)))
        seq = mutate(rng, g[s:s + rl], error)
        strand = int(rng.integers(0, 2))
        if strand:
            seq = revcomp(seq)
        reads.append((f"sim/{i:06d}/{strand}_{rl}", seq))
        truth.append((s, s + rl, strand))
    return reads, truth


def write_reads(reads, fasta_path: str, lst_path: str) -> None:
    """Write reads as one FASTA file plus the reads.lst manifest naming it."""
    with open(fasta_path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    with open(lst_path, "w") as f:
        f.write(fasta_path + "\n")
