"""The port's CLI verbs beside asm, and the batched long-sequence route,
through both packages on the CPU: identical outputs.

`seqdb`, `dump-index`, `stats`, `gather-mc` and `map` run through
pg-tpu's and pg-tpu-torch's main() (the port with --device cpu) on the
same inputs: files byte for byte and stdout line for line.  build_index's
long route (sequences past sketch_pad_len) sketches the segments of all
long sequences in shared batches of LONG_BATCH rows and reduces each
length class once a level; its index files equal the JAX package's,
which sketches and reduces one sequence at a time.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from peregrine_tpu import cli as jax_cli
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import index as jindex
from peregrine_tpu_torch import cli
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io import formats
from peregrine_tpu_torch.io.seqdb import SeqDB, seq_to_codes
from peregrine_tpu_torch.ops import index, reduce, sketch
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

K12 = ["--shimmer-k", "12", "--shimmer-w", "24", "--shimmer-r", "4",
       "--min_len", "2000"]
# reference pieces: two through the batch route (< 32,768 b) and one
# through the long route as one segment (32,768 < n <= 40,960)
PIECES = (12_000, 14_000, 34_000)


def _main(pkg, argv, capsys):
    assert pkg.main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Reads of a 60 kb genome, the genome cut into PIECES, both as
    FASTA manifests, and the port's asm output on the reads."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(11)
    genome = random_genome(rng, sum(PIECES))
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=6.0)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    cuts = np.cumsum((0,) + PIECES)
    ref = [(f"piece{i}", genome[a:b])
           for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]
    ref_lst = str(d / "ref.lst")
    write_reads(ref, str(d / "ref.fa"), ref_lst)
    wd = str(d / "wd")
    assert cli.main(["asm", lst, "--output", wd, "--device", "cpu"]
                    + K12) == 0
    return d, lst, ref_lst, wd


def test_seqdb_matches_jax(data, capsys):
    d, lst, _, _ = data
    outs = [_main(pkg, ["seqdb", lst, str(d / name)], capsys)
            for pkg, name in ((jax_cli, "jax_sdb"), (cli, "torch_sdb"))]
    assert outs[0] == outs[1]
    for ext in (".seqdb", ".idx"):
        assert filecmp.cmp(str(d / ("jax_sdb" + ext)),
                           str(d / ("torch_sdb" + ext)), shallow=False), ext


@pytest.mark.parametrize("limit", [0, 7])
def test_dump_index_matches_jax(data, capsys, limit):
    *_, wd = data
    argv = ["dump-index", os.path.join(wd, "1-index", "shmr-L2-01-of-01.dat"),
            "--limit", str(limit)]
    out = _main(cli, argv, capsys)
    assert out == _main(jax_cli, argv, capsys)
    assert len(out.splitlines()) == (limit or len(formats.read_mmlist(
        argv[1])[0]))


@pytest.mark.parametrize("as_prefix", [False, True])
def test_stats_matches_jax(data, capsys, as_prefix):
    *_, wd = data
    argv = (["stats", os.path.join(wd, "0-seqdb", "seq_dataset"), "--prefix"]
            if as_prefix else ["stats", wd])
    out = _main(cli, argv, capsys)
    assert out == _main(jax_cli, argv, capsys)
    assert out.startswith("seqdb: ")
    assert ("SHIMMERs" in out and "overlaps:" in out) != as_prefix


def test_gather_mc_matches_jax(data, capsys, tmp_path):
    """Chunk files that share mers: counts sum per mer."""
    *_, wd = data
    h, c = formats.read_mm_count(
        os.path.join(wd, "1-index", "shmr-L2-MC-01-of-01.dat"))
    rng = np.random.default_rng(3)
    parts = []
    for i in range(3):
        sel = np.sort(rng.choice(len(h), len(h) // 2, replace=False))
        parts.append(str(tmp_path / f"x-MC-{i + 1:02d}-of-03.dat"))
        formats.write_mm_count(parts[-1], h[sel], c[sel])
    outs = []
    for pkg, name in ((jax_cli, "jax"), (cli, "torch")):
        outs.append(_main(pkg, ["gather-mc", *parts, "--output",
                                str(tmp_path / f"{name}-MC-all.dat")],
                          capsys))
    assert outs[0] == outs[1]
    assert filecmp.cmp(str(tmp_path / "jax-MC-all.dat"),
                       str(tmp_path / "torch-MC-all.dat"), shallow=False)


def test_map_matches_jax(data, capsys):
    d, lst, ref_lst, _ = data
    for name, src in (("reads", lst), ("ref", ref_lst)):
        assert cli.main(["seqdb", src, str(d / name)]) == 0
    capsys.readouterr()
    ref, reads = str(d / "ref"), str(d / "reads")
    want = _main(jax_cli, ["map", ref, reads], capsys)
    assert _main(cli, ["map", ref, reads, "--device", "cpu"], capsys) == want
    rows = np.array([ln.split() for ln in want.splitlines()], np.int64)
    # every piece has reads mapped to it, the long-route one included
    assert set(rows[:, 0]) == set(range(len(PIECES)))
    # --output writes the same rows to a file
    out = str(d / "rows.txt")
    assert _main(cli, ["map", ref, reads, "--device", "cpu",
                       "--output", out], capsys) == ""
    with open(out) as f:
        assert f.read() == want


def test_map_refusals(data, tmp_path, capsys):
    """--shimmer-k outside 1..28 exits non-zero; the default device is
    cuda, with no quiet switch to the CPU."""
    d, *_ = data
    with pytest.raises(SystemExit) as exc:
        cli.main(["map", "ref", "reads", "--shimmer-k", "29"])
    assert exc.value.code != 0
    assert "outside 1..28" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["map", str(d / "ref"), str(d / "reads"), "--output",
                  str(tmp_path / "rows.txt")])
    assert not os.path.exists(tmp_path / "rows.txt")


def _long_set():
    """80 sequences of 1.2-6 kb (four contents, copies apart), a 30 kb and
    a 20 kb sequence whose segments cross the first and second batch
    boundaries at sketch_pad_len=1024, and short reads between them."""
    rng = np.random.default_rng(5)
    contents = [random_genome(rng, int(n)) for n in
                rng.integers(1200, 6001, 4)]
    seqs = [contents[i] for i in rng.permutation(np.arange(80) % 4)]
    seqs = (seqs[:50] + [random_genome(rng, 30_000)] + seqs[50:]
            + [random_genome(rng, 20_000)])
    reads = []
    for i, s in enumerate(seqs):
        reads.append((f"long{i}", s))
        if i % 5 == 0:
            reads.append((f"read{i}", random_genome(
                rng, int(rng.integers(300, 1000)))))
    return reads


@pytest.mark.parametrize("k,keep_l0", [(12, False), (28, True)])
def test_long_route_batched_matches_jax(tmp_path, k, keep_l0, monkeypatch):
    reads = _long_set()
    kw = dict(k=k, w=24, r=4, levels=2, sketch_pad_len=1024, sketch_batch=16)
    want = jindex.build_index(JaxSeqDB.from_reads(reads), JaxConfig(**kw),
                              keep_l0=keep_l0)
    calls = {"sketch_batch": 0, "reduce_flat_np": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(sketch, "sketch_batch")
    counted(index, "reduce_flat_np")
    db = SeqDB.from_reads(reads)
    got = index.build_index(db, AsmConfig(**kw), "cpu", keep_l0=keep_l0)
    levels = ((2, 0) if keep_l0 else (2,))
    for lv, g, j in zip(levels, got if keep_l0 else (got,),
                        want if keep_l0 else (want,)):
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(g, f), getattr(j, f),
                                          err_msg=f"L{lv} {f}")
        g.save(str(tmp_path / "torch" / "shmr"), level=lv)
        j.save(str(tmp_path / "jax" / "shmr"), level=lv)
        for name in (f"shmr-L{lv}-01-of-01.dat", f"shmr-L{lv}-MC-01-of-01.dat"):
            assert filecmp.cmp(str(tmp_path / "torch" / name),
                               str(tmp_path / "jax" / name), shallow=False)
    made = dict(calls)
    # one sketch_batch call per LONG_BATCH segments across sequences
    long_lens = [len(s) for _, s in reads if len(s) > 1024]
    segments = sum(len(sketch._segments(n, 1024, 1 << 12)) for n in long_lens)
    assert segments == 80 + 30 + 20
    assert made["sketch_batch"] == -(-segments // sketch.LONG_BATCH) == 3
    # each reduction level once per length class of level-0 counts
    l0 = got[1] if keep_l0 else index.build_index(
        db, AsmConfig(**kw), "cpu", keep_l0=True)[1]
    rids = (l0.y >> np.uint64(32)).astype(np.int64)
    counts = np.bincount(rids, minlength=len(reads))[
        [i for i, (_, s) in enumerate(reads) if len(s) > 1024]]
    classes = len({int(n).bit_length() for n in counts})
    assert made["reduce_flat_np"] == 2 * classes < 2 * len(long_lens)


def test_long_route_rows_keep_their_rids(monkeypatch):
    """Segments of different sequences share a batch, and each record's y
    is rebuilt from its own segment's rid and offset: with the batches cut
    to one row, or to every segment at once, the records are the same,
    including for a rid at and past 2^31."""
    rng = np.random.default_rng(9)
    seqs = [(rid, seq_to_codes(random_genome(rng, n)))
            for rid, n in ((3, 5000), (1 << 31, 12_000), ((1 << 32) - 1,
                                                          2500))]
    args = (12, 10, "cpu")
    kw = dict(seg=2048, margin=512)
    shared = sketch.sketch_long_many_np(seqs, *args, **kw)
    for batch in (1, 1000):
        monkeypatch.setattr(sketch, "LONG_BATCH", batch)
        again = sketch.sketch_long_many_np(iter(seqs), *args, **kw)
        for (x, y), (x2, y2) in zip(shared, again):
            np.testing.assert_array_equal(x, x2)
            np.testing.assert_array_equal(y, y2)
    for (rid, codes), (x, y) in zip(seqs, shared):
        one = sketch.sketch_long_np(codes, rid, *args, **kw)
        np.testing.assert_array_equal(one[0], x)
        np.testing.assert_array_equal(one[1], y)
        assert len(y) and ((y >> np.uint64(32)) == rid).all()
    # the reduction's rows come back split per rid
    x = np.concatenate([x for x, _ in shared])
    y = np.concatenate([y for _, y in shared])
    rx, ry = reduce.reduce_flat_np(x, y, 4, "cpu")
    for (rid, _), (sx, sy) in zip(seqs, shared):
        ox, oy = reduce.reduce_flat_np(sx, sy, 4, "cpu")
        mine = (ry >> np.uint64(32)) == rid
        np.testing.assert_array_equal(rx[mine], ox)
        np.testing.assert_array_equal(ry[mine], oy)
