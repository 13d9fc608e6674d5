"""The port's spans (peregrine_tpu_torch.trace) on the CPU.

A tiny read set (a 30 kb genome, 10x of 3 kb reads) runs through stages
0-4 three times: with the host aligner, the same under profiled() (the
torch.profiler trace of --profile-dir), and with the device aligner and
the device pair map (their plain versions).  Each stage's spans and
their children must exist, nest inside their parent's interval and carry
the assembly's id; the stage walls must be their spans' seconds; the
counters must add up to what the stage logs; the profiler's trace must
hold the spans inside their stage's; and the outputs must not change
under the profiler.  The ring must drop its oldest records past its
bound.
"""

import filecmp
import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from peregrine_tpu_torch import trace
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.ops import consensus
from peregrine_tpu_torch.pipeline.run import Assembly, profiled
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

CFG = dict(k=16, w=24, r=4, min_len=2000)
WALLS = {"seqdb", "index", "overlap", "layout", "ctg_index", "mapping",
         "consensus"}
# each stage span's children, and the children of some of those
CHILDREN = {
    "seqdb": {"seqdb.upload_start", "seqdb.encode"},
    "index": {"index.upload_seqdb", "index.bucket", "index.index_of",
              "index.save"},
    "index.bucket": {"index.metas", "index.eager", "index.fetches",
                     "index.slicing"},
    "overlap": {"overlap.pairs", "overlap.stream", "overlap.round",
                "overlap.final", "overlap.write"},
    "layout": {"layout.string_graph", "layout.graph", "layout.tiling",
               "layout.contigs"},
    "polish": {"polish.ctg_db", "ctg_index", "mapping", "consensus"},
    "consensus": {"consensus.plan", "consensus.windows", "consensus.stitch",
                  "consensus.write"},
    "consensus.windows": {"consensus.window"},
}
OUTPUTS = ("1-index/shmr-L2-01-of-01.dat", "1-index/shmr-L2-MC-01-of-01.dat",
           "2-ovlp/preads.ovl", "3-asm/p_ctg.fa", "4-cns/read_map.txt",
           "4-cns/p_ctg_cns.fa")


class _Log(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.walls, self.messages = [], []

    def emit(self, record):
        self.messages.append(record.getMessage())
        if hasattr(record, "stage_wall"):
            self.walls.append(record.stage_wall)


def _assemble(out, lst, device_stage2=False, profile_dir=None):
    """Stages 0-4 as `pg-tpu-torch asm --with-consensus` runs them, two
    workers; returns the assembly, the spans it opened (in the order
    they closed), its log and the consensus plans' window count."""
    lg = logging.getLogger("peregrine_tpu_torch")
    log = _Log()
    lg.addHandler(log)
    level = lg.level
    lg.setLevel(logging.INFO)
    planned = []
    plan_all = consensus.plan_all

    def counted(*a, **kw):
        plans = plan_all(*a, **kw)
        planned.append(sum(len(s) for s in plans.values()))
        return plans

    consensus.plan_all = counted
    before = {r.id for r in trace.records()}
    try:
        asm = Assembly(out, AsmConfig(**CFG, use_device_aligner=device_stage2,
                                      device_pairs=device_stage2),
                       device="cpu")
        with profiled(profile_dir, asm.device):
            asm.build_db(reads_list=lst)
            asm.build_shimmer_index()
            asm.build_overlaps(2, 2)
            asm.build_contigs()
            asm.build_consensus(2)
    finally:
        consensus.plan_all = plan_all
        lg.removeHandler(log)
        lg.setLevel(level)
    recs = [r for r in trace.records() if r.id not in before]
    return asm, recs, log, sum(planned)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 30_000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=10.0)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    return {
        "host": _assemble(str(d / "host"), lst),
        "profiled": _assemble(str(d / "profiled"), lst,
                              profile_dir=str(d / "prof")),
        "device": _assemble(str(d / "device"), lst, device_stage2=True),
        "dir": d,
    }


@pytest.mark.parametrize("run", ["host", "device"])
def test_span_tree(runs, run):
    asm, recs, _, _ = runs[run]
    by_id = {r.id: r for r in recs}
    assert {r.asm for r in recs} == {asm.asm_id}
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent:
            p = by_id[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1, (r, p)
    stages = [r for r in recs if not r.parent]
    assert [r.name for r in sorted(stages, key=lambda r: r.t0)] == \
        ["seqdb", "index", "overlap", "layout", "polish"]
    kids: dict = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    for name, want in CHILDREN.items():
        parents = [r for r in recs if r.name == name]
        assert want <= {c.name for p in parents for c in kids[p.id]}, name
    rounds = [r for r in recs if r.name == "overlap.round"]
    want = ({"overlap.collect", "overlap.align", "overlap.merge"}
            if run == "device" else
            {"overlap.collect", "overlap.aligner", "overlap.merge"})
    assert want <= {c.name for r in rounds for c in kids.get(r.id, [])}
    if run == "device":
        assert "overlap.upload" in {r.name for r in recs}
        assert sum(r.attrs.get("lanes", 0) for r in recs
                   if r.name == "overlap.align") > 0
    else:
        for r in rounds:
            assert r.attrs["workers"] == 2
            assert r.attrs["busy_s"] >= 0 and r.attrs["wait_s"] >= 0
    # a window's worker thread: the pool's span is its parent
    (pool,) = [r for r in recs if r.name == "consensus.windows"]
    windows = [r for r in recs if r.name == "consensus.window"]
    assert {w.parent for w in windows} == {pool.id}
    assert all(w.attrs["decode_s"] + w.attrs["native_s"]
               <= w.t1 - w.t0 for w in windows)


@pytest.mark.parametrize("run", ["host", "device"])
def test_stage_walls_are_span_seconds(runs, run):
    _, recs, log, _ = runs[run]
    assert {name for name, _ in log.walls} == WALLS
    assert len(log.walls) == len(WALLS)
    for name, seconds in log.walls:
        (r,) = [r for r in recs if r.name == name]
        assert seconds == r.seconds


@pytest.mark.parametrize("run", ["host", "device"])
def test_counters_add_up(runs, run):
    _, recs, log, planned = runs[run]
    (said,) = [m for m in log.messages
               if m.startswith("overlap dedup [")]
    total = int(said.split("]: ")[1].split()[0])
    aligned = sum(r.attrs["aligned"] for r in recs
                  if r.name == "overlap.round")
    (final,) = [r for r in recs if r.name == "overlap.final"]
    assert aligned > 0 and aligned + final.attrs["inline"] == total
    (pool,) = [r for r in recs if r.name == "consensus.windows"]
    windows = [r for r in recs if r.name == "consensus.window"]
    assert planned > 0 and len(windows) == planned == pool.attrs["windows"]
    assert pool.attrs["workers"] == 2


def test_profiler_trace_holds_the_spans(runs):
    (path,) = glob.glob(str(runs["dir"] / "prof" / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("pg."):
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(inner, outer):
        (a, b), (c, d) = spans[inner][0], spans[outer][0]
        return c <= a and b <= d

    assert inside("pg.overlap.final", "pg.overlap")
    assert inside("pg.consensus.windows", "pg.consensus")
    assert inside("pg.consensus", "pg.polish")
    assert len(spans["pg.overlap.round"]) >= 1


def test_outputs_same_under_the_profiler(runs):
    a, b = runs["host"][0].outdir, runs["profiled"][0].outdir
    for name in OUTPUTS:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_ring_drops_its_oldest():
    with trace.span("ring.first") as first:
        pass
    for i in range(trace.RING):
        with trace.span("ring.fill", i=i):
            pass
    recs = trace.records()
    assert len(recs) == trace.RING
    assert first.id not in {r.id for r in recs}
    assert recs[0].name == "ring.fill" and recs[0].attrs["i"] == 0
    assert recs[-1].attrs["i"] == trace.RING - 1


def test_span_nesting_and_explicit_parent():
    import threading
    with trace.span("outer", asm=99) as outer:
        with trace.span("inner") as inner:
            inner.attrs["n"] = 3
        seen = []

        def work():
            with trace.span("pooled", parent=outer) as sp:
                seen.append(sp)

        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert inner.parent == outer.id and inner.asm == 99
    assert seen[0].parent == outer.id and seen[0].asm == 99
    with trace.span("alone") as alone:
        with trace.span("alone.inner") as inner:
            pass
    assert alone.parent == 0 and alone.asm == 0
    assert inner.parent == alone.id


def test_spans_from_many_threads():
    """Threads opening spans at once (more of them than cores, the
    interpreter switching often) lose no record, share no id, and keep
    each thread's parent."""
    import sys
    import threading
    n_threads, n_spans = (os.cpu_count() or 1) + 2, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with trace.span("stress") as root:
            def work(i):
                with trace.span("stress.thread", parent=root) as t:
                    for j in range(n_spans):
                        with trace.span("stress.inner", i=i, j=j):
                            if j % 50 == 0:   # snapshots while others append
                                trace.records()
                    t.attrs["i"] = i

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    recs = [r for r in trace.records() if r.name.startswith("stress")]
    assert len(recs) == 1 + n_threads * (n_spans + 1)
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "stress.inner":
            assert by_id[r.parent].attrs["i"] == r.attrs["i"]
        elif r.name == "stress.thread":
            assert r.parent == root.id
