"""Stage 2's rejecter rule, on the CPU.

A collect-mode replay (native/overlap_replay.cpp) that meets a cache miss
of a rid pair whose cached alignment already failed the accept test in
the same pass collects it as a rejection: the pair is not marked
pending and the anchor's overlap count does not grow, so one pass
collects the rest of the pair's anchors and the candidates the failed
slot opens.  The final pass stays exact, so the records do not change.

1. A hand-made stream: one rid pair anchored in three buckets, its first
   anchor cached as a failure.  One collect pass collects exactly the
   keys the exact pass consults when every anchor of the pair fails;
   with the first anchor cached as a pass, it collects nothing more.
2. A 100 kb repeat genome (simdata.repeat_genome: diverged dispersed
   copies, a tandem array, segmental duplications) at 16x of 4 kb reads:
   overlap_all_spec's records equal the plain exact replay's
   (overlap_chunk_native with no cache) and the JAX package's, at 1, 2
   and 4 workers and on two loopback ranks of a shard= harvest, whose
   ranks collect the same requests every round; the device backend,
   which keeps the optimistic rule, equals the JAX package's device
   backend (its plain version on the CPU) and, on a CUDA card, itself
   on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from peregrine_tpu_torch import native, trace
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import overlap as ov
from peregrine_tpu_torch.ops.index import build_index
from peregrine_tpu_torch.simdata import (random_genome, repeat_genome,
                                         simulate_reads)

torch.set_num_threads(2)

# --- 1. the rule on a hand-made stream --------------------------------

A, B, C = 0, 1, 2
RLEN, BESTN, FUZZ, MIN_ALN, BAND = 10_000, 1, 400, 300, 100
# (rid, position) of each bucket's entries in stream order (descending
# position): the replay anchors at entry n-2 down to 0 and extends each
# anchor to the entries after it.  Bucket 1 holds the pair's first anchor;
# in bucket 2 the anchor B meets C, then A meets B and, past B's slot, C;
# bucket 3 holds the pair's third anchor.
BUCKETS = [[(A, 7000), (B, 1000)],
           [(A, 7200), (B, 1200), (C, 200)],
           [(A, 7400), (B, 1400)]]


def _stream():
    ys, pos = [], []
    for bucket in BUCKETS:
        for rid, p in bucket:
            ys.append((rid << 32) | (p << 1))
            pos.append(p)
    ends = np.cumsum([len(b) for b in BUCKETS])
    return (np.array(ys, np.uint64), np.zeros(len(ys), np.uint8),
            np.array(pos, np.int64), np.concatenate([[0], ends[:-1]]),
            ends)


def _key(rid, p):
    return (rid << 33) | (p << 1)


def _result(key, passes):
    """A cached alignment along the anchor diagonal to the query's end
    (an OVERLAP at these shifts), or of 500 bases (failing the accept
    test)."""
    shift = ((key[0] >> 1) & 0xFFFFFFFF) - ((key[1] >> 1) & 0xFFFFFFFF)
    e = RLEN - shift if passes else 500
    return [e, 10, 0, e, 0, e, e, e]


@pytest.fixture(scope="module")
def reads_db():
    rng = np.random.default_rng(3)
    return SeqDB.from_reads([(f"r{i}", random_genome(rng, RLEN))
                             for i in range(3)])


def _replay(db, cache, collect, rule=True):
    ka = np.array([k[0] for k, _ in cache], np.uint64)
    kb = np.array([k[1] for k, _ in cache], np.uint64)
    res = np.array([r for _, r in cache], np.int32).reshape(-1, 8)
    return native.overlap_replay(
        *_stream(), db.data, db.offsets, db.lengths, BESTN, FUZZ, MIN_ALN,
        BAND, ka, kb, res, collect_misses=collect, collect_rejecters=rule)


def _keys(reqs):
    return [(_key(int(r["rid0"]), int(r["pos0"])),
             _key(int(r["rid1"]), int(r["pos1"]))) for r in reqs]


FIRST = (_key(A, 7001), _key(B, 1001))
AB2, AB3 = (_key(A, 7201), _key(B, 1201)), (_key(A, 7401), _key(B, 1401))
BC2, AC2 = (_key(B, 1201), _key(C, 201)), (_key(A, 7201), _key(C, 201))


def test_failing_anchor_collects_the_rest_of_its_chain(reads_db):
    failed = [(FIRST, _result(FIRST, False))]
    _, n, miss, rej, reqs = _replay(reads_db, failed, collect=True)
    # the pair's anchors 2 and 3 as rejections; A-C, which anchor 2's
    # failed slot opens under bestn 1; B-C as before
    assert _keys(reqs) == [BC2, AB2, AC2, AB3]
    assert (n, miss, rej) == (0, 4, 2)
    # without the rule anchor 2 is assumed an overlap: 3 and A-C wait
    _, _, miss, rej, reqs = _replay(reads_db, failed, collect=True,
                                    rule=False)
    assert _keys(reqs) == [BC2, AB2]
    assert (miss, rej) == (2, 1)


def test_rejections_follow_the_exact_pass(reads_db):
    """With every anchor of the pair failing, the exact pass consults
    exactly the collected keys: given all of them it aligns nothing
    inline, and each one it is not given it aligns inline."""
    results = {k: _result(k, k in (BC2, AC2))
               for k in (FIRST, AB2, AB3, BC2, AC2)}
    collected = [BC2, AB2, AC2, AB3]
    raw, n, miss, rej = _replay(reads_db, list(results.items()),
                                collect=False)
    assert (n, miss, rej) == (2, 0, 0)
    recs = np.frombuffer(raw, ov.OVLP_DTYPE)
    assert sorted(zip((recs["y0"] >> np.uint64(32)).tolist(),
                      (recs["y1"] >> np.uint64(32)).tolist())) \
        == [(A, C), (B, C)]
    for k in collected:
        _, _, miss, _ = _replay(reads_db, [kv for kv in results.items()
                                           if kv[0] != k], collect=False)
        assert miss >= 1, k
    # the exact pass counts inline misses of pairs with a failing cached
    # anchor without changing what it does
    _, _, miss, rej = _replay(reads_db, [(FIRST, _result(FIRST, False))],
                              collect=False)
    assert miss >= 2 and rej >= 1


def test_passing_anchor_collects_nothing_more(reads_db):
    raw, n, miss, rej, reqs = _replay(
        reads_db, [(FIRST, _result(FIRST, True))], collect=True)
    assert _keys(reqs) == [BC2]
    assert (n, miss, rej) == (1, 1, 0)


# --- 2. whole harvests on a repeat genome -----------------------------

CFG = dict(k=12, w=24, r=4, levels=2, min_len=2500, sketch_pad_len=8192,
           sketch_batch=16, aln_batch=64, aln_max_len=8192)


@pytest.fixture(scope="module")
def repeats():
    rng = np.random.default_rng(9)
    chroms, _ = repeat_genome(rng, 100_000, n_chrom=1, tandem_per_mb=20.0,
                              segdup_len=(15_000, 25_000))
    reads, _ = simulate_reads(rng, chroms[0], read_len=4000, coverage=16.0,
                              circular_wrap=8000)
    cfg = AsmConfig(**CFG)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, cfg, "cpu")
    exact = ov.overlap_chunk_native(db, idx, cfg)[0]
    return reads, cfg, db, idx, exact


@pytest.fixture(scope="module")
def jax_records(repeats):
    """The JAX package's overlap_all_spec records on the same reads, by
    backend."""
    from peregrine_tpu.config import AsmConfig as JaxConfig
    from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
    from peregrine_tpu.ops import index as jax_index
    from peregrine_tpu.ops import overlap as jax_overlap
    reads = repeats[0]
    jcfg, jdb = JaxConfig(**CFG), JaxSeqDB.from_reads(reads)
    jidx = jax_index.build_index(jdb, jcfg)
    return {b: jax_overlap.overlap_all_spec(jdb, jidx, jcfg, n_workers=2,
                                            backend=b)
            for b in ("host", "device")}


def _same_records(a, b):
    assert a.dtype == b.dtype and len(a) == len(b)
    assert a.tobytes() == b.tobytes()


def _with_spans(fn):
    """fn()'s result and the program's overlap spans it left."""
    t = time.perf_counter()
    out = fn()
    return out, [r for r in trace.records()
                 if r.t0 >= t and r.name in ("overlap.round",
                                             "overlap.final")]


def _rejecters(spans):
    return sum(r.attrs["rejecters"] for r in spans
               if r.name == "overlap.round")


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_harvest_matches_the_exact_replay(repeats, jax_records, n_workers):
    _, cfg, db, idx, exact = repeats
    got, spans = _with_spans(lambda: ov.overlap_all_spec(
        db, idx, cfg, n_workers=n_workers))
    assert len(got) > 1000
    _same_records(got, exact)
    _same_records(got, jax_records["host"])
    assert _rejecters(spans) > 0
    final = [r for r in spans if r.name == "overlap.final"]
    assert len(final) == 1
    assert 0 <= final[0].attrs["rejecter_inline"] <= final[0].attrs["inline"]


def test_sharded_ranks_collect_the_same_requests(repeats, jax_records):
    """Two loopback ranks of a shard= harvest: each aligns its block-
    cyclic share, the exchange fills the peer's rows as the peer would,
    both collect the same requests every round, and rank 0's records
    are the exact replay's."""
    _, cfg, db, idx, exact = repeats
    collected = {0: [], 1: []}

    def loopback(rank):
        def exchange(rnd, reqs, res, mine):
            collected[rank].append(reqs.tobytes())
            peer = np.flatnonzero(~mine)
            if len(peer):
                res[peer] = ov._align_parallel(reqs[peer], db, db.data,
                                               cfg.aln_bw, 2)
            return res
        return exchange

    got, spans = _with_spans(lambda: ov.overlap_all_spec(
        db, idx, cfg, n_workers=2, shard=(0, 2), exchange=loopback(0)))
    assert ov.overlap_all_spec(db, idx, cfg, n_workers=2, shard=(1, 2),
                               exchange=loopback(1), run_final=False) is None
    _same_records(got, exact)
    _same_records(got, jax_records["host"])
    assert len(collected[0]) >= 2
    assert collected[0] == collected[1]
    assert _rejecters(spans) > 0


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_device_backend_keeps_its_records(repeats, request, device):
    """The device backend's aligner gives other results than the final
    pass's inline one, so it keeps the optimistic rule: its records stay
    the JAX package's device backend's (the plain aligner on the CPU),
    and on a card those of its own plain version; its rounds count the
    rejecters they meet."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cfg, db, idx, _ = repeats
    got, spans = _with_spans(lambda: ov.overlap_all_spec(
        db, idx, cfg, n_workers=2, backend="device", device=device))
    # the JAX package is not installed beside a card
    want = (request.getfixturevalue("jax_records")["device"]
            if device == "cpu"
            else ov.overlap_all_spec(db, idx, cfg, n_workers=2,
                                     backend="device", device="cpu"))
    _same_records(got, want)
    assert all("rejecters" in r.attrs for r in spans
               if r.name == "overlap.round")
