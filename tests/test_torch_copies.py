"""The port's copies of the JAX package's host modules stay true to their
sources.

The machine with the card has no jax, and importing anything of
peregrine_tpu imports jax, so the port holds copies of the framework-free
host modules.  Each must equal its source line for line, apart from the
lines listed here (imports, the logger's name, docstrings, where the
native library is built): a change to a source then fails this test
until the copy follows it.  The native host library's C++ sources, which
the port compiles from its own copies, must equal theirs byte for byte,
but for overlap_replay.cpp's listed lines (the port's rejecter rule).
"""

import difflib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# module -> the lines the copy removes ("-") and adds ("+"), in diff order
ALLOWED = {
    "config.py": [],
    "io/__init__.py": [],
    "io/formats.py": [],
    "io/seqdb.py": [],
    "graph/__init__.py": [],
    "graph/contig.py": [],
    "graph/digraph.py": [],
    "graph/layout.py": [],
    "graph/string_graph.py": [],
    "graph/tiling.py": [],
    "ops/mapping.py": [
        "+",
        "+A copy of peregrine_tpu/ops/mapping.py (host numpy); the changes: the",
        "+logger's name, and the pair map's rebuild runs under the span",
        "+mapping.pairs (peregrine_tpu_torch.trace; attr entries), whose seconds",
        "+its log line gives.",
        "+from .. import trace",
        "-    py/scripts/pg_run.py:491-496).  The TPU-native equivalent skips the",
        "+    py/scripts/pg_run.py:491-496).  This equivalent skips the",
        "-        import time as _t",
        "-        _tr = _t.time()",
        "-        key0, key1, y0a, y1a, dira = build_pairs(",
        "-            read_idx, read_lengths, chunk, total_chunk,",
        "-            cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist,",
        "-            spill_dir=cfg.spill_dir)",
        '-        logging.getLogger("peregrine_tpu").info(',
        '+        with trace.span("mapping.pairs") as sp:',
        "+            key0, key1, y0a, y1a, dira = build_pairs(",
        "+                read_idx, read_lengths, chunk, total_chunk,",
        "+                cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist,",
        "+                spill_dir=cfg.spill_dir)",
        '+            sp.attrs["entries"] = len(key0)',
        '+        logging.getLogger("peregrine_tpu_torch").info(',
        "-            _t.time() - _tr, len(key0),",
        "+            sp.seconds, len(key0),",
    ],
    "ops/consensus.py": [
        "+",
        "+A copy of peregrine_tpu/ops/consensus.py (host numpy and the native",
        "+window core); the one change: consensus_windows runs each window under a",
        "+span (peregrine_tpu_torch.trace), whose attrs window_consensus's `times`",
        "+fills.",
        "+import time",
        "+",
        "+from .. import trace",
        "-                     use_native: bool = True) -> bytes:",
        "+                     use_native: bool = True, times: dict | None = None",
        "+                     ) -> bytes:",
        '-    semantic reference used for cross-checking."""',
        "+    semantic reference used for cross-checking.  With use_native, `times`",
        "+    takes the seconds of the Python decode (decode_s) and of the native",
        '+    call (native_s)."""',
        "+    t0 = time.perf_counter()",
        "-        return window_cns(ref_seq, read_seqs, shifts,",
        "-                          cfg.cns_aln_band, cfg.cns_min_cov)",
        "+        t1 = time.perf_counter()",
        "+        out = window_cns(ref_seq, read_seqs, shifts,",
        "+                         cfg.cns_aln_band, cfg.cns_min_cov)",
        "+        if times is not None:",
        "+            times.update(decode_s=t1 - t0,",
        "+                         native_s=time.perf_counter() - t1)",
        "+        return out",
        '-    total_chunks; windows balance better when contig sizes skew)."""',
        "+    total_chunks; windows balance better when contig sizes skew).",
        "+",
        "+    Spans: consensus.windows (attrs windows, workers) over the pool, and",
        "+    one consensus.window under it a window, in its worker thread (attrs",
        '+    reads, decode_s, native_s)."""',
        "-    with cf.ThreadPoolExecutor(max_workers=max(1, n_workers)) as ex:",
        "-        futs = {ex.submit(window_consensus, read_db, ref_db, rid,",
        "-                          spec[0], spec[1], spec[2], cfg): (rid, i)",
        "+    n_workers = max(1, n_workers)",
        "+",
        "+    def window(parent, rid, spec):",
        '+        with trace.span("consensus.window", parent=parent,',
        "+                        reads=len(spec[2])) as sp:",
        "+            return window_consensus(read_db, ref_db, rid, spec[0], spec[1],",
        "+                                    spec[2], cfg, times=sp.attrs)",
        "+",
        '+    with trace.span("consensus.windows", windows=len(jobs),',
        "+                    workers=n_workers) as sp, \\",
        "+            cf.ThreadPoolExecutor(max_workers=n_workers) as ex:",
        "+        futs = {ex.submit(window, sp, rid, spec): (rid, i)",
    ],
    "ops/chain.py": [
        "+",
        "+A copy of peregrine_tpu/ops/chain.py (host code; unchanged).",
    ],
    "verify.py": [
        "+",
        "+A copy of peregrine_tpu/verify.py (numpy only; unchanged).",
    ],
    "native/__init__.py": [
        "-The shared object is compiled on demand from the committed C++ sources",
        "-(g++ -O3) into this package directory; rebuilds happen automatically when",
        "-sources are newer than the binary.",
        "+A copy of peregrine_tpu/native/__init__.py with two changes: the shared",
        "+object is built on first use from this package's copies of the C++",
        "+sources (peregrine_tpu_torch/native/*.cpp, byte for byte the JAX",
        "+package's but overlap_replay.cpp) into peregrine_tpu_torch/build/ (see",
        "+_build.build_shared); and overlap_replay takes the collect pass's",
        "+rejecter rule and returns its count, which the port's",
        "+overlap_replay.cpp adds.",
        "-import subprocess",
        "+",
        "+from .._build import build_shared",
        '-_SO = os.path.join(_DIR, "_pgnative.so")',
        "-",
        "-",
        "-def _build() -> None:",
        '-    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",',
        '-           "-o", _SO] + _SRC + ["-lz"]',
        "-    subprocess.run(cmd, check=True, capture_output=True)",
        "-    need = (not os.path.exists(_SO)",
        "-            or any(os.path.getmtime(s) > os.path.getmtime(_SO) for s in _SRC))",
        "-    if need:",
        "-        _build()",
        "-    return ctypes.CDLL(_SO)",
        '+    so = build_shared("pgnative", _SRC,',
        '+                      ["g++", "-O3", "-march=native", "-shared", "-fPIC"],',
        '+                      libs=["-lz"])',
        "+    return ctypes.CDLL(so)",
        "-    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]    # stream buf/cap/prog",
        "+    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,    # stream buf/cap/prog",
        "+    ctypes.c_int32, _i64p]                               # rule, rejecters",
        "-                   stream_progress: np.ndarray | None = None):",
        "+                   stream_progress: np.ndarray | None = None,",
        "+                   collect_rejecters: bool = False):",
        "-    (raw record bytes, n_records, n_cache_misses[, miss_requests]).",
        "+    (raw record bytes, n_records, n_cache_misses, n_rejecter_misses[,",
        "+    miss_requests]), n_rejecter_misses being the misses whose rid pair",
        "+    had a cached result failing the accept test earlier in the pass.",
        "-    driver in ops.overlap.overlap_all_spec.  The caller parses the record",
        "+    driver in ops.overlap.overlap_all_spec.  With collect_rejecters too,",
        "+    such a rejecter miss is collected as a rejection (not assumed an",
        "+    overlap), so the pass collects the rest of the pair's anchors.  The",
        "+    caller parses the record",
        "+    n_rej = ctypes.c_int64()",
        "-                          sbp, scap, spp)",
        "+                          sbp, scap, spp, int(collect_rejecters),",
        "+                          ctypes.byref(n_rej))",
        "-        return raw, int(n_out.value), int(n_miss.value), miss_arr",
        "-    return raw, int(n_out.value), int(n_miss.value)",
        "+        return (raw, int(n_out.value), int(n_miss.value),",
        "+                int(n_rej.value), miss_arr)",
        "+    return raw, int(n_out.value), int(n_miss.value), int(n_rej.value)",
    ],
}


# the native host library's C++ sources, which the port compiles from its
# own copies: each must equal its source byte for byte, apart from the
# lines listed in NATIVE_ALLOWED
NATIVE_SOURCES = sorted(
    p.name for p in (ROOT / "peregrine_tpu" / "native").glob("*.cpp"))

# source -> the lines the port's copy removes and adds: the collect
# pass's rejecter rule and its count
NATIVE_ALLOWED = {
    "overlap_replay.cpp": [
        "-// to the true replay's so later rounds collect few corrections",
        "+// to the true replay's.  A pair whose cached alignment already failed the",
        "+// accept test in this pass is not assumed so (see collect_rejecters):",
        "+// such pairs fail again at many later anchors (tandem arrays, diverged",
        "+// copies), and marking one pending at each round's first new anchor left",
        "+// the rest of its chain, one anchor a round, to the exact final pass",
        "-// request and treated as a reject (no record, no state change) instead of",
        "-// aligning inline — the driver aligns the collected requests in parallel",
        "+// request instead of aligning inline (and its pair marked kPending) — the",
        "+// driver aligns the collected requests in parallel",
        "+//",
        "+// collect_rejecters (collect mode): a miss whose rid pair has a cached",
        "+// result failing the accept test earlier in this pass is collected",
        "+// without marking the pair kPending or counting it as an overlap — the",
        "+// pass goes on as the exact pass goes on after a rejection, so it also",
        "+// collects the pair's later anchors and the candidates a failed slot",
        "+// opens.  The rule reads only the stream and the cache, so every rank",
        "+// of a sharded harvest collects the same requests.  *n_rejecters counts",
        "+// the misses whose pair had such a failing cached anchor, in either",
        "+// mode and whether or not the rule is on.",
        "-                      int64_t *stream_progress) {",
        "+                      int64_t *stream_progress, int32_t collect_rejecters,",
        "+                      int64_t *n_rejecters) {",
        "+  PairMap rejected;  // rid pairs with a failing cached result this pass",
        "+  rejected.init(4096);",
        "+  int64_t rejecters = 0;",
        "+          const bool known = rejected.find(ridp) != nullptr;",
        "+          rejecters += known;",
        "+          if (known && collect_rejecters) continue;  // as a rejection",
        "+          rejecters += rejected.find(ridp) != nullptr;",
        "+        if (!ok && hit >= 0) rejected.put(ridp, 1);",
        "+  *n_rejecters = rejecters;",
    ],
}


def _changed_lines(source: str, copy: str) -> list[str]:
    diff = difflib.unified_diff(source.splitlines(), copy.splitlines(),
                                lineterm="", n=0)
    return [ln for ln in diff
            if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]


@pytest.mark.parametrize("module", sorted(ALLOWED))
def test_copy_matches_its_source(module):
    source = (ROOT / "peregrine_tpu" / module).read_text()
    copy = (ROOT / "peregrine_tpu_torch" / module).read_text()
    assert _changed_lines(source, copy) == ALLOWED[module], (
        f"peregrine_tpu_torch/{module} drifted from peregrine_tpu/{module}: "
        "carry the source's change over, or list the line here")


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_source_copy_is_byte_identical(name):
    source = (ROOT / "peregrine_tpu" / "native" / name).read_bytes()
    copy = (ROOT / "peregrine_tpu_torch" / "native" / name).read_bytes()
    if name in NATIVE_ALLOWED:
        assert _changed_lines(source.decode(), copy.decode()) \
            == NATIVE_ALLOWED[name], (
            f"peregrine_tpu_torch/native/{name} drifted from "
            f"peregrine_tpu/native/{name}: carry the source's change "
            "over, or list the line here")
        return
    assert copy == source, (
        f"peregrine_tpu_torch/native/{name} drifted from "
        f"peregrine_tpu/native/{name}: copy the source over again")


def test_native_library_builds_from_every_copy():
    """native._SRC lists exactly the port's copies, one per source."""
    from peregrine_tpu_torch import native

    assert sorted(pathlib.Path(p).name for p in native._SRC) == NATIVE_SOURCES
    assert len(NATIVE_SOURCES) == 12


def test_every_copied_module_is_checked():
    """Every port module whose source sits at the same path in the JAX
    package is a copy listed above, or one of the ported modules."""
    ported = {"__init__.py", "api.py", "cli.py", "ops/__init__.py",
              "ops/dbgather.py", "ops/device_align.py", "ops/device_pairs.py",
              "ops/index.py", "ops/overlap.py", "ops/reduce.py",
              "ops/sketch.py", "parallel/__init__.py",
              "parallel/distributed.py", "parallel/sharded_index.py",
              "parallel/sharded_overlap.py", "parallel/sharded_pairs.py",
              "pipeline/__init__.py", "pipeline/run.py"}
    port = ROOT / "peregrine_tpu_torch"
    twins = {str(p.relative_to(port)) for p in port.rglob("*.py")
             if (ROOT / "peregrine_tpu" / p.relative_to(port)).exists()}
    assert twins == set(ALLOWED) | ported


def test_a_changed_source_fails():
    src = (ROOT / "peregrine_tpu" / "ops" / "chain.py").read_text()
    copy = (ROOT / "peregrine_tpu_torch" / "ops" / "chain.py").read_text()
    drifted = src.replace("def ", "def  ", 1)
    assert _changed_lines(drifted, copy) != ALLOWED["ops/chain.py"]
