"""Seeded genomes and long reads for the benchmark (NumPy, vectorised).

One generator for every configuration: a configuration file names the
genome model ("random", "repeats", or another whose file
genomes/<model>.py makes it) and the read model; the same seed gives the
same genome and the same reads.  The semantics follow
Peregrine's test/ecoli_K12/simulate_reads.py: reads of a normal length
drawn uniformly from the genome (with its first `wrap` bases appended
for a circular one), errors at `error` a base split evenly between
substitution, deletion and insertion, and a random strand.  Unlike a
loop over reads, every step here works on a whole file of reads at once.

Where a configuration gives a `layout_seed`, the reads' lengths, starts
and strands (and a repeat genome's repeat places) come from that fixed
seed: every run seed then has the same set of sizes, in its own order,
with its own sequence and errors, so that the seed does not change the
amount of work.

A genome of several sequences (a model file's) shares each file's reads
among them in proportion to their lengths, by a draw from the layout
seed where there is one; a read lies inside one sequence.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

import plugins

HERE = os.path.dirname(os.path.abspath(__file__))
BUILTIN_MODELS = ("random", "repeats")

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any size of integer)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def random_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, n)]


def mutate_many(rng: np.random.Generator, seq: np.ndarray,
                lengths: np.ndarray, rate: float):
    """Errors at `rate` a base in each of the segments of `seq` (their
    lengths in `lengths`): a hit is a substitution, a deletion or an
    insertion after the base with equal odds.  Returns the mutated
    concatenation and the segments' new lengths."""
    n = len(seq)
    hit = rng.random(n) < rate
    kind = rng.integers(0, 3, n)
    base = ACGT[rng.integers(0, 4, n)]
    out = np.where(hit & (kind == 0), base, seq)
    emit = np.ones(n, np.int64)
    emit[hit & (kind == 1)] = 0
    ins = hit & (kind == 2)
    emit[ins] = 2
    dest = np.cumsum(emit) - emit
    res = np.empty(int(emit.sum()), np.uint8)
    keep = emit > 0
    res[dest[keep]] = out[keep]
    res[dest[ins] + 1] = base[ins]
    seg_starts = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=seg_starts[1:])
    new_len = np.add.reduceat(emit, seg_starts) if n else lengths * 0
    return res, new_len


def repeat_genome(rng: np.random.Generator, spec: dict,
                  events_out: list | None = None,
                  layout: np.random.Generator | None = None) -> np.ndarray:
    """A genome with repeats of fixed sizes, mutated from the seed and
    placed by `layout` (by the seed where it is None): dispersed copies
    of one ancestral unit (85-95% identity, half of them 5'-truncated,
    half reverse-complemented), tandem arrays of given unit lengths and
    copy numbers (2% a copy), and segmental duplications of given lengths
    copied elsewhere at 99% identity.  events_out collects [kind, start,
    length] of each pasted repeat and [segdup, source, length, dest], in
    the final genome's coordinates."""
    lay = rng if layout is None else layout
    n = int(spec["genome_length"])
    unit = int(spec["disp_unit_len"])
    ancestral = random_genome(rng, unit)
    backbone = random_genome(rng, n)
    events = []
    n_disp = int(spec["disp_frac"] * n / unit)
    for p in lay.integers(0, n - unit, n_disp):
        events.append((int(p), "disp", None))
    for ul, copies in spec["tandem"]:
        events.append((int(lay.integers(0, n - 200_000)), "tand", (ul, copies)))
    events.sort(key=lambda e: e[0])
    parts, pos = [], 0
    lo, hi = spec["disp_div"]
    for p, kind, arg in events:
        if p < pos:
            continue
        parts.append(backbone[pos:p])
        if kind == "disp":
            copy, _ = mutate_many(rng, ancestral, np.array([unit]),
                                  float(lay.uniform(lo, hi)))
            if lay.random() < 0.5:  # 5'-truncated
                copy = copy[int(lay.integers(0, unit // 2)):]
            if lay.random() < 0.5:
                copy = revcomp(copy)
        else:
            ul, copies = arg
            u = random_genome(rng, ul)
            copy, _ = mutate_many(rng, np.tile(u, copies),
                                  np.full(copies, ul), spec["tandem_div"])
        parts.append(copy)
        if events_out is not None:
            events_out.append([kind, sum(len(x) for x in parts[:-1]),
                               len(copy)])
        pos = p + len(copy)
    parts.append(backbone[pos:])
    g = np.concatenate(parts)
    for length in spec["segdup_lengths"]:
        s = int(lay.integers(0, len(g) - length))
        dup, _ = mutate_many(rng, g[s:s + length], np.array([length]),
                             spec["segdup_div"])
        d = int(lay.integers(0, len(g)))
        g = np.concatenate([g[:d], dup, g[d:]])
        if events_out is not None:
            # what lies at or past d moves on by the copy's length
            for e in events_out:
                for i in ((1, 3) if e[0] == "segdup" else (1,)):
                    e[i] += len(dup) if e[i] >= d else 0
            events_out.append(["segdup", s + (len(dup) if s >= d else 0),
                               length, d])
    return g


@dataclasses.dataclass
class Genome:
    """The sequences that reads are drawn from, each with its name and
    whether it is circular, and what its model tells the checks of it
    (`truth`: for example the places of heterozygous variants)."""
    seqs: list
    names: list
    circular: list
    truth: object = None


def genome(seed: int, cfg: dict, events_out: list | None = None,
           root: str = HERE) -> Genome:
    """The configuration's genome for the seed.  The built-in models make
    one sequence, circular where the configuration gives a `wrap`; any
    other model is the function genome(rng, spec, layout) of
    <root>/genomes/<model>.py, called with the seed's genome stream, the
    configuration's genome spec and the stream of its layout_seed (None
    without one), which returns ([(name, uint8 ACGT array, circular),
    ...], truth)."""
    spec = cfg["genome"]
    rng = rng_for(seed, 1)
    layout = (rng_for(spec["layout_seed"], 1) if "layout_seed" in spec
              else None)
    circular = [bool(spec.get("wrap", 0))]
    if spec["model"] == "random":
        return Genome([random_genome(rng, int(spec["genome_length"]))],
                      ["genome"], circular)
    if spec["model"] == "repeats":
        return Genome([repeat_genome(rng, spec, events_out, layout=layout)],
                      ["genome"], circular)
    seqs, truth = plugins.load(root, "genomes", spec["model"], "genome")(
        rng, spec, layout)
    names = [str(n) for n, _, _ in seqs]
    if not seqs or len(set(names)) < len(names):
        raise ValueError(f"genome model {spec['model']!r}: give one or more "
                         f"sequences with distinct names, not {names}")
    for n, s, c in seqs:
        if not (isinstance(s, np.ndarray) and s.dtype == np.uint8):
            raise ValueError(f"genome model {spec['model']!r}: sequence "
                             f"{n!r} is not a uint8 array")
        if c and not spec.get("wrap", 0):
            raise ValueError(f"genome model {spec['model']!r}: sequence "
                             f"{n!r} is circular, and the configuration's "
                             f"genome gives no wrap")
    return Genome([s for _, s, _ in seqs], names,
                  [bool(c) for _, _, c in seqs], truth)


def read_source(g: np.ndarray, cfg: dict) -> np.ndarray:
    """The sequence reads are drawn from: the genome, with its first
    `wrap` bases appended where it is circular."""
    wrap = int(cfg["genome"].get("wrap", 0))
    return np.concatenate([g, g[:wrap]]) if wrap else g


def simulate_seqs(rng: np.random.Generator, srcs: list, n_reads: int,
                  spec: dict, layout: np.random.Generator | None = None):
    """One file's reads from several sources: (concatenated bases, lengths,
    starts, strands, lengths before the errors, sources); a read covers
    srcs[source][start:start + length before the errors], so none crosses
    from one source to the next.  Each read's source is drawn in
    proportion to the sources' lengths; with one source nothing is drawn.
    The reads' sources, lengths, starts and strands come from `layout`
    where given (the same set for every seed, in an order drawn from rng),
    else from rng.  Errors are drawn as positions (a binomial count of
    them), so the work goes with the errors and not with every base."""
    rl = int(spec["read_len"])
    lay = rng if layout is None else layout
    src_lens = np.array([len(s) for s in srcs], np.int64)
    which = (lay.choice(len(srcs), n_reads, p=src_lens / src_lens.sum())
             if len(srcs) > 1 else np.zeros(n_reads, np.int64))
    lens = np.maximum(rl // 3, (rl + lay.normal(0, spec["len_sd"], n_reads))
                      .astype(np.int64))
    room = src_lens[which] - lens
    if (room < 0).any():
        raise ValueError(f"a read of {int(lens[room < 0].max())} bases is "
                         f"longer than its sequence")
    starts = (lay.random(n_reads) * room).astype(np.int64)
    strands = lay.integers(0, 2, n_reads)
    if layout is not None:
        order = rng.permutation(n_reads)
        lens, starts, strands = lens[order], starts[order], strands[order]
        which = which[order]
    cat = np.concatenate([srcs[w][a:a + n] for w, a, n in zip(
        which.tolist(), starts.tolist(), lens.tolist())])
    total = len(cat)
    pos = np.unique(rng.integers(0, total, rng.binomial(total, spec["error"])))
    kind = rng.integers(0, 3, len(pos))
    base = ACGT[rng.integers(0, 4, len(pos))]
    sub, dele, ins = (kind == 0), (kind == 1), (kind == 2)
    cat[pos[sub]] = base[sub]
    seg_starts = np.zeros(n_reads, np.int64)
    np.cumsum(lens[:-1], out=seg_starts[1:])
    owner = np.searchsorted(seg_starts, pos, side="right") - 1
    new_len = (lens + np.bincount(owner[ins], minlength=n_reads)
               - np.bincount(owner[dele], minlength=n_reads))
    d, i = pos[dele], pos[ins]
    # a base inserted after each position of i, in the array without d
    out = np.insert(np.delete(cat, d), i - np.searchsorted(d, i) + 1, base[ins])
    # reverse-complement the reads on strand 1, each within its own span
    offs = np.zeros(n_reads, np.int64)
    np.cumsum(new_len[:-1], out=offs[1:])
    for r in np.flatnonzero(strands == 1).tolist():
        a, e = offs[r], offs[r] + new_len[r]
        out[a:e] = _COMP[out[a:e][::-1]]
    return out, new_len, starts, strands, lens, which


def write_fasta(path: str, seq: np.ndarray, lens: np.ndarray,
                names: list[str]) -> None:
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = seq.tobytes()
    with open(path, "wb", buffering=1 << 22) as f:
        for i, name in enumerate(names):
            f.write(b">%s\n" % name.encode())
            f.write(data[offs[i]:offs[i + 1]])
            f.write(b"\n")


def write_reads(seed: int, cfg: dict, gnm: Genome, outdir: str,
                warm_span: int):
    """Write the configuration's read files of the seed's genome `gnm`
    (genome(seed, cfg)) and their manifest under outdir, and a warm-up
    manifest of the reads drawn from the first `warm_span` bases of each
    sequence's source.  Returns (manifest, warm-up manifest, number of
    reads, bases, layout), one file's arrays in memory at a time; layout
    holds each read's (start in its source, length before the errors,
    strand, sequence), in the order of the manifest."""
    srcs = [read_source(g, cfg) if c else g
            for g, c in zip(gnm.seqs, gnm.circular)]
    spec = cfg["reads"]
    n_files = int(spec["files"])
    per_file = int(spec["reads_per_file"])
    os.makedirs(outdir, exist_ok=True)
    paths, warm, layouts = [], [], []
    n_reads = bases = 0
    for fi in range(n_files):
        layout = (rng_for(spec["layout_seed"], 2, fi) if "layout_seed" in spec
                  else None)
        seq, lens, starts, strands, true_lens, which = simulate_seqs(
            rng_for(seed, 2, fi), srcs, per_file, spec, layout)
        layouts.append(np.stack([starts, true_lens, strands, which], 1))
        names = [f"sim/{fi:02d}{i:05d}/{s}_{n}" for i, (s, n)
                 in enumerate(zip(strands.tolist(), lens.tolist()))]
        path = os.path.join(outdir, f"reads_{fi:02d}.fa")
        write_fasta(path, seq, lens, names)
        paths.append(path)
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        for i in np.flatnonzero(starts < warm_span):
            warm.append((names[i], seq[offs[i]:offs[i + 1]].copy()))
        n_reads += per_file
        bases += int(lens.sum())
    manifest = os.path.join(outdir, "reads.lst")
    with open(manifest, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    warm_fa = os.path.join(outdir, "warm.fa")
    write_fasta(warm_fa, np.concatenate([s for _, s in warm]),
                np.array([len(s) for _, s in warm]), [n for n, _ in warm])
    warm_lst = os.path.join(outdir, "warm.lst")
    with open(warm_lst, "w") as f:
        f.write(warm_fa + "\n")
    return (manifest, warm_lst, n_reads, bases,
            np.concatenate(layouts).astype(np.int64))


def read_fasta(path: str):
    """(name, ACGT uint8 array) of each record of a FASTA file with one
    line a sequence (as write_fasta and the assembler write them)."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for rec in data.split(b">")[1:]:
        head, _, rest = rec.partition(b"\n")
        seq = rest.replace(b"\n", b"")
        out.append((head.split()[0].decode() if head.split() else "",
                    np.frombuffer(seq, np.uint8)))
    return out


def manifest_reads(manifest: str):
    """Every read of a manifest's files, in order, as uint8 arrays."""
    with open(manifest) as f:
        for line in f:
            if line.strip():
                for _, s in read_fasta(line.strip()):
                    yield s
