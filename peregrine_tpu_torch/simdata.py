"""Seeded simulated genomes and error-laden long reads (numpy only).

The same generator as tests/simdata.py (random_genome, mutate,
simulate_reads, repeat_genome; the same numpy draws, so the same seed gives the same
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


def repeat_genome(rng: np.random.Generator, n: int, *, n_chrom: int = 1,
                  disp_unit_len: int = 5000, disp_frac: float = 0.06,
                  disp_div: tuple[float, float] = (0.05, 0.15),
                  tandem_per_mb: float = 0.25,
                  tandem_unit: tuple[int, int] = (171, 2000),
                  tandem_copies: tuple[int, int] = (10, 60),
                  tandem_div: float = 0.02,
                  n_segdup: int = 4,
                  segdup_len: tuple[int, int] = (50_000, 500_000),
                  segdup_div: float = 0.01,
                  hap_div: float = 0.0):
    """Repeat-stressed genome: exercises the string graph's hard paths
    (bundles, compound paths, alt contigs), which uniform-random genomes
    never fire.  The same generator as tests/simdata.repeat_genome (the
    same numpy draws, so the same seed gives the same genome).

    Repeat classes:

      * dispersed elements (LINE-like): ONE ancestral ~5 kb unit; copies
        at 85-95%% identity pasted over ``disp_frac`` of every
        chromosome, half of them 5'-truncated and half reverse-complemented;
      * tandem arrays (satellite-like): per locus, a random 171-2000 bp
        unit repeated 10-60x with 2%% per-copy divergence;
      * segmental duplications: ``n_segdup`` source windows of
        50-500 kb (at most a tenth of the chromosome) copied to another
        locus at ~99%% identity;
      * optional second haplotype: hap_div > 0 appends a mutated copy
        of every chromosome (diploid sample).

    Returns (chroms, info): chroms = list[bytes]; info records the
    pasted repeat intervals and segdup (src, dst) loci.
    """
    base, rem = divmod(n, n_chrom)
    clens = [base + (1 if i < rem else 0) for i in range(n_chrom)]
    ancestral = random_genome(rng, disp_unit_len)
    info = {"dispersed": [], "tandem": [], "segdup": [],
            "ancestral_len": disp_unit_len}
    chroms: list[bytes] = []
    for ci, clen in enumerate(clens):
        parts: list[bytes] = []
        pos = 0
        events = []  # (pos, kind)
        n_disp = int(disp_frac * clen / disp_unit_len)
        for p in sorted(rng.integers(0, max(1, clen - disp_unit_len),
                                     n_disp).tolist()):
            events.append((p, "disp"))
        n_tand = max(1, int(tandem_per_mb * clen / 1e6))
        for p in sorted(rng.integers(0, max(1, clen - 200_000),
                                     n_tand).tolist()):
            events.append((p, "tand"))
        events.sort()
        backbone = random_genome(rng, clen)
        for p, kind in events:
            if p < pos:
                continue  # overlapping event: skip
            parts.append(backbone[pos:p])
            if kind == "disp":
                div = float(rng.uniform(*disp_div))
                copy = mutate(rng, ancestral, div)
                if rng.random() < 0.5:  # 5'-truncation
                    copy = copy[int(rng.integers(0, len(copy) // 2)):]
                if rng.random() < 0.5:
                    copy = revcomp(copy)
                parts.append(copy)
                info["dispersed"].append((ci, p, len(copy), div))
                pos = p + len(copy)
            else:
                ul = int(rng.integers(*tandem_unit))
                k = int(rng.integers(*tandem_copies))
                unit = random_genome(rng, ul)
                arr = b"".join(mutate(rng, unit, tandem_div)
                               for _ in range(k))
                parts.append(arr)
                info["tandem"].append((ci, p, ul, k))
                pos = p + len(arr)
        parts.append(backbone[pos:])
        chroms.append(b"".join(parts))

    # segmental duplications over the repeat-bearing sequence (so dups
    # carry their dispersed/tandem content, like real SDs)
    for si in range(n_segdup):
        L = int(rng.integers(*segdup_len))
        src_c = int(rng.integers(0, n_chrom))
        # keep toy-scale genomes near their nominal size
        L = min(L, len(chroms[src_c]) // 10)
        if L < 1000 or len(chroms[src_c]) < L + 2:
            continue
        s = int(rng.integers(0, len(chroms[src_c]) - L))
        dup = mutate(rng, chroms[src_c][s:s + L], segdup_div)
        dst_c = int(rng.integers(0, n_chrom))
        d = int(rng.integers(0, len(chroms[dst_c])))
        chroms[dst_c] = chroms[dst_c][:d] + dup + chroms[dst_c][d:]
        info["segdup"].append((src_c, s, L, dst_c, d))

    if hap_div > 0:
        hap2 = [mutate(rng, c, hap_div) for c in chroms]
        info["haplotypes"] = 2
        chroms = chroms + hap2
    return chroms, info
