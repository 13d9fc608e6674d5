"""Assembly pipeline orchestrator, stages 0-3 (the draft path).

The port of peregrine_tpu/pipeline/run.py's default path.  Stages run
in-process with file-checkpointed outputs in the reference's directory
layout, byte-identical to the JAX package's, so either package resumes
the other's output directory:

    0-seqdb/   seq_dataset.seqdb + .idx
    1-index/   shmr-L{level}-*.dat + MC files
    2-ovlp/    preads.ovl
    3-asm/     sg_edges_list, utg_data, ctg_paths, p_ctg_tiling_path, p_ctg.fa

Stage 1 runs on the given device (the SHIMMER kernels); stages 0, 2 and 3
are host numpy and native C++.  Not yet ported (each raises): stage 4
consensus, the mesh/multihost runs, and the device pair map and aligner.
"""

from __future__ import annotations

import logging
import os
import resource
import time

import torch

from ..config import AsmConfig
from ..graph.contig import tiling_to_contigs
from ..graph.layout import assemble_graph
from ..graph.string_graph import generate_string_graph
from ..graph.tiling import tiling_paths
from ..io.seqdb import SeqDB
from ..ops.index import ShimmerIndex, build_index
from ..ops.overlap import overlap_all

log = logging.getLogger("peregrine_tpu_torch")

# Batching/padding knobs that change execution shape but not outputs; a
# resume may differ on these without invalidating stage checkpoints.
_NON_SEMANTIC_CFG_FIELDS = frozenset(
    {"sketch_pad_len", "sketch_batch", "aln_batch", "aln_max_len",
     "spill_dir", "device_pairs"})


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to peregrine_tpu_torch (ROADMAP: {item})")


class ConfigMismatchError(RuntimeError):
    """Raised when resuming an outdir whose config.json disagrees with the
    current AsmConfig on an output-affecting field."""


def _semantic_cfg_diff(old: AsmConfig, new: AsmConfig) -> dict:
    import dataclasses as _dc
    o, n = _dc.asdict(old), _dc.asdict(new)
    return {k: (o[k], n[k]) for k in o
            if k not in _NON_SEMANTIC_CFG_FIELDS and o.get(k) != n[k]}


def _stage_done(path: str) -> bool:
    return os.path.exists(path)


def _device_db_budget(device: torch.device) -> int:
    """Max seqdb bytes whose packed planes (~0.375x the seqdb bytes) may
    be resident on the device at once; PG_HBM_DB_BUDGET (seqdb bytes)
    overrides.  On a card: the seqdb size whose planes take a quarter of
    the free device memory, leaving the rest to the index batches.  The
    CPU device has no such limit."""
    env = os.environ.get("PG_HBM_DB_BUDGET")
    if env:
        return int(env)
    if device.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(device)
    return int(free / 4 / 0.375)


def _device_mem_line(device: torch.device) -> str:
    if device.type != "cuda":
        return ""
    return "; device peak %.2f GB" % (
        torch.cuda.max_memory_allocated(device) / (1 << 30))


def _mem_budget() -> int:
    """Host anonymous-memory budget in bytes for the overlap stage's
    pair map + request/result caches.  PG_MEM_BUDGET (bytes) overrides;
    the default is 85% of MemAvailable at call time."""
    env = os.environ.get("PG_MEM_BUDGET")
    if env:
        return int(float(env))
    try:
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemAvailable"):
                    return int(int(ln.split()[1]) * 1024 * 0.85)
    except OSError:
        pass
    return 1 << 62


def _anon_rss_gb() -> float:
    """Current anonymous RSS in GB (RssAnon)."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("RssAnon"):
                    return int(ln.split()[1]) / (1 << 20)
    except OSError:
        pass
    return 0.0


def _peak_rss_gb() -> float:
    """Process high-water RSS in GB: VmHWM, or getrusage's ru_maxrss
    where /proc reports no high-water mark (some sandboxed kernels)."""
    hwm = 0
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmHWM"):
                    hwm = int(ln.split()[1])
    except OSError:
        pass
    kb = max(hwm, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    return kb / (1 << 20)


def _spill_free_bytes(spill_dir: str) -> int:
    """Free bytes on the filesystem holding spill_dir (statvfs)."""
    st = os.statvfs(spill_dir)
    return st.f_bavail * st.f_frsize


def _preflight_spill(spill_dir: str, projected: int, what: str) -> None:
    """Fail fast when the spill filesystem cannot hold the projected
    on-disk spill peak (~0.22x the seqdb bytes, see the JAX package).
    PG_SPILL_PREFLIGHT=0 disables the gate."""
    if os.environ.get("PG_SPILL_PREFLIGHT", "1") == "0":
        return
    free = _spill_free_bytes(spill_dir)
    if free < projected:
        raise RuntimeError(
            f"spill preflight: {what} projects ~{projected / (1 << 30):.1f} "
            f"GB of spill but {spill_dir} has only {free / (1 << 30):.1f} GB "
            f"free — point --spill-dir at a larger filesystem, free disk, "
            f"or set PG_SPILL_PREFLIGHT=0 to proceed anyway")
    log.info("spill preflight: %s projects ~%.1f GB; %s has %.1f GB free",
             what, projected / (1 << 30), spill_dir, free / (1 << 30))


def _write_lines(path: str, lines) -> None:
    # checkpoint files are written atomically (tmp + rename) so a crash
    # mid-write cannot leave a truncated file that resume trusts
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    os.replace(tmp, path)


class Assembly:
    """Per-stage state of one assembly; file outputs double as checkpoints.

    Each stage's log record carries `stage_wall` = (stage, seconds) for
    callers that collect stage walls (chip_smoke.py)."""

    def __init__(self, outdir: str, cfg: AsmConfig = AsmConfig(),
                 device="cuda", with_alt: bool = False,
                 on_config_change: str = "error"):
        """device: where stage 1 runs ("cuda" or "cpu"; no fallback).
        on_config_change: when outdir holds checkpoints written under a
        semantically different AsmConfig — "error" (refuse), "clean"
        (invalidate stages 1-4 and re-run), or "ignore"."""
        assert on_config_change in ("error", "clean", "ignore")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no "
                               "CUDA device (pass --device cpu explicitly to "
                               "run stage 1 on the host)")
        if cfg.mesh or cfg.device_pairs:
            raise not_ported("--mesh / --device-pairs", "queue 1, flag paths")
        if cfg.use_device_aligner or cfg.hybrid_overlap or cfg.shard_overlap:
            raise not_ported("the device aligner", "queue 1, flag paths")
        self.outdir = outdir
        self.cfg = cfg
        self.with_alt = with_alt
        cfg_path = os.path.join(outdir, "config.json")
        if os.path.exists(cfg_path) and on_config_change != "ignore":
            try:
                old = AsmConfig.from_json(open(cfg_path).read())
            except (TypeError, ValueError):
                old = None  # unreadable/older schema: treat as mismatch
            diff = (_semantic_cfg_diff(old, cfg) if old is not None
                    else {"<config.json>": ("unreadable", "current")})
            if diff:
                if on_config_change == "error":
                    raise ConfigMismatchError(
                        f"{outdir} holds checkpoints built with a different "
                        f"config: {diff}. Pass on_config_change='clean' to "
                        "invalidate stages 1-4, or 'ignore' to proceed.")
                self._invalidate_stages()
                log.warning("config changed (%s): invalidated stage 1-4 "
                            "checkpoints in %s", diff, outdir)
        for d in ("0-seqdb", "1-index", "2-ovlp", "3-asm", "4-cns"):
            os.makedirs(os.path.join(outdir, d), exist_ok=True)
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        self.db: SeqDB | None = None
        self.idx: ShimmerIndex | None = None
        self._save_thread = None  # async stage-0 checkpoint write
        self._pairs = None        # read pair map (stage 2)

    def _invalidate_stages(self) -> None:
        """Remove config-dependent stage checkpoints (1-index through 4-cns
        and the alt-polish dir); the stage-0 seqdb only depends on the reads."""
        import shutil
        for d in ("1-index", "2-ovlp", "3-asm", "4-cns", "4-cns-alt"):
            p = os.path.join(self.outdir, d)
            if os.path.isdir(p):
                shutil.rmtree(p)

    # --- stage 0: sequence database ------------------------------------
    def build_db(self, reads=None, reads_list: str | None = None) -> SeqDB:
        prefix = os.path.join(self.outdir, "0-seqdb", "seq_dataset")
        if _stage_done(prefix + ".idx") and reads is None:
            self.db = SeqDB.open(prefix)
        elif reads is None:
            # manifest input streams straight to disk: peak RSS is one
            # read + the write buffer; the pipeline then reads back
            # through a page-cache-governed memmap
            t0 = time.time()
            self.db = SeqDB.build_to_disk(reads_list, prefix)
            wall = time.time() - t0
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs streamed "
                     "to disk; peak RSS %.1f GB)", len(self.db),
                     int(self.db.lengths.sum()), wall, _peak_rss_gb(),
                     extra={"stage_wall": ("seqdb", wall)})
        else:
            t0 = time.time()
            self.db = SeqDB.from_reads(reads)
            # the checkpoint write overlaps the index stage; save() writes
            # .seqdb before .idx, and resume trusts .idx
            import threading
            self._save_thread = threading.Thread(
                target=self.db.save, args=(prefix,), name="seqdb-save")
            self._save_thread.start()
            wall = time.time() - t0
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs; "
                     "checkpoint writes in background)",
                     len(self.db), int(self.db.lengths.sum()), wall,
                     extra={"stage_wall": ("seqdb", wall)})
        return self.db

    # --- stage 1: SHIMMER index ----------------------------------------
    def build_shimmer_index(self) -> ShimmerIndex:
        prefix = os.path.join(self.outdir, "1-index", "shmr")
        level = self.cfg.levels
        mm = f"{prefix}-L{level}-01-of-01.dat"
        mc = f"{prefix}-L{level}-MC-01-of-01.dat"
        if _stage_done(mm):
            self.idx = ShimmerIndex.load_chunks([mm], [mc])
        else:
            t0 = time.time()
            budget = _device_db_budget(self.device)
            if self.db.data.nbytes > budget:
                raise not_ported(
                    f"indexing a {self.db.data.nbytes / (1 << 30):.1f} GB "
                    f"seqdb past the {budget / (1 << 30):.1f} GB device "
                    "budget", "queue 1, the in-process segmented build")
            self.idx = build_index(self.db, self.cfg, self.device)
            self.idx.save(prefix, level=level)
            wall = time.time() - t0
            log.info("stage 1 index: %d SHIMMERs, %d distinct (%.1fs on %s; "
                     "peak RSS %.1f GB%s)",
                     len(self.idx.x), len(self.idx.mc_hash), wall,
                     self.device, _peak_rss_gb(),
                     _device_mem_line(self.device),
                     extra={"stage_wall": ("index", wall)})
        return self.idx

    def _pair_map(self):
        """The unchunked oriented read pair map (host build)."""
        if self._pairs is None:
            self._maybe_auto_spill()
            from ..ops.overlap import build_pairs
            self._pairs = build_pairs(
                self.idx, self.db.lengths, 1, 1, self.cfg.mc_lower,
                self.cfg.mc_upper, self.cfg.min_anchor_dist,
                spill_dir=self.cfg.spill_dir)
        return self._pairs

    def _maybe_auto_spill(self) -> None:
        """Self-sizing low-memory mode: when the projected anonymous
        footprint of the overlap stage (~2.0x the seqdb bytes, measured
        in the JAX package's scale runs) exceeds the host budget, back
        its buffers with unlinked spill files automatically."""
        if self.cfg.spill_dir is not None or self.db is None:
            return
        projected = int(2.0 * self.db.data.nbytes)
        budget = _mem_budget()
        if projected <= budget:
            return
        import dataclasses
        d = os.path.join(self.outdir, "spill")
        os.makedirs(d, exist_ok=True)
        _preflight_spill(d, int(0.22 * self.db.data.nbytes),
                         "auto-spill (overlap stage)")
        self.cfg = dataclasses.replace(self.cfg, spill_dir=d)
        log.info("auto-spill: projected overlap anon ~%.1f GB exceeds "
                 "the %.1f GB budget (PG_MEM_BUDGET/MemAvailable) — "
                 "pair map + overlap caches spill to %s",
                 projected / (1 << 30), budget / (1 << 30), d)

    # --- stage 2: overlaps ---------------------------------------------
    def build_overlaps(self, n_chunks: int | None = None,
                       n_workers: int | None = None) -> str:
        path = os.path.join(self.outdir, "2-ovlp", "preads.ovl")
        if not _stage_done(path):
            t0 = time.time()
            self._maybe_auto_spill()
            if self.cfg.spill_dir is not None and self.db is not None:
                # explicit --spill-dir: same capacity gate auto-spill gets
                os.makedirs(self.cfg.spill_dir, exist_ok=True)
                _preflight_spill(self.cfg.spill_dir,
                                 int(0.22 * self.db.data.nbytes),
                                 "overlap stage spill")
            if self.cfg.dedup_overlap and self.cfg.spill_dir is not None:
                # low-memory mode: overlap_all_spec builds and frees its
                # own pair map (stage 4, which would share it, is not
                # ported)
                from ..ops.overlap import overlap_all_spec
                ovlps = overlap_all_spec(
                    self.db, self.idx, self.cfg,
                    n_workers=n_workers or (os.cpu_count() or 1),
                    backend="host")
            else:
                if n_workers is None:
                    n_workers = 1 if len(self.db) < 2000 else (os.cpu_count() or 1)
                n_chunks = n_chunks or n_workers
                ovlps = overlap_all(
                    self.db, self.idx, self.cfg,
                    n_chunks=n_chunks, n_workers=n_workers,
                    pairs=(self._pair_map()
                           if self.cfg.dedup_overlap and n_workers > 1
                           else None))
            from ..ops.overlap import write_ovl_file
            n_rows = write_ovl_file(path, ovlps)
            self._pairs = None  # only stage 4 would reuse it
            wall = time.time() - t0
            log.info("stage 2 overlap: %d records -> %d rows (%.1fs; "
                     "peak RSS %.1f GB, anon %.1f GB)",
                     len(ovlps), n_rows, wall, _peak_rss_gb(),
                     _anon_rss_gb(), extra={"stage_wall": ("overlap", wall)})
        return path

    # --- stage 3: layout + draft contigs --------------------------------
    def build_contigs(self) -> str:
        asm = os.path.join(self.outdir, "3-asm")
        fa = os.path.join(asm, "p_ctg.fa")
        if _stage_done(fa):
            return fa
        t0 = time.time()
        with open(os.path.join(self.outdir, "2-ovlp", "preads.ovl"),
                  "rb") as f:
            result = generate_string_graph(
                ovl_bytes=f.read(), min_len=self.cfg.min_len,
                min_idt=self.cfg.min_idt, lfc=self.cfg.lfc,
                disable_chimer_bridge_removal=self.cfg.disable_chimer_bridge_removal)
        sg_path = os.path.join(asm, "sg_edges_list")
        if result.sg_edge_bytes is not None:
            with open(sg_path + ".tmp", "wb") as f:
                f.write(result.sg_edge_bytes)
            os.replace(sg_path + ".tmp", sg_path)
        else:
            _write_lines(sg_path, result.sg_edge_lines)
        _write_lines(os.path.join(asm, "chimers_nodes"), result.chimer_nodes)

        u_edge_data, ctg_rows, utg_rows, compound_rows = assemble_graph(result)
        _write_lines(os.path.join(asm, "utg_data"), utg_rows)
        _write_lines(os.path.join(asm, "ctg_paths"), ctg_rows)
        _write_lines(os.path.join(asm, "c_path"), compound_rows)

        p_lines, a_lines = tiling_paths(result.sg_edge_lines, utg_rows,
                                        ctg_rows,
                                        edge_data=result.tiling_edge_data())
        _write_lines(os.path.join(asm, "p_ctg_tiling_path"), p_lines)
        _write_lines(os.path.join(asm, "a_ctg_tiling_path"), a_lines)

        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        contigs = tiling_to_contigs(self.db, p_lines)
        with open(fa + ".tmp", "w") as f:
            for name, seq in contigs:
                f.write(f">{name}\n{seq.decode()}\n")
        os.replace(fa + ".tmp", fa)
        if self.with_alt and a_lines:
            # alternate (bubble-branch) contigs, reference --with-alt
            # (py/scripts/pg_run.py:359-371)
            a_contigs = tiling_to_contigs(self.db, a_lines)
            with open(os.path.join(asm, "a_ctg.fa"), "w") as f:
                for name, seq in a_contigs:
                    f.write(f">{name}\n{seq.decode()}\n")
        wall = time.time() - t0
        log.info("stage 3 layout: %d contigs, %d bases (%.1fs; "
                 "peak RSS %.1f GB)",
                 len(contigs), sum(len(s) for _, s in contigs),
                 wall, _peak_rss_gb(), extra={"stage_wall": ("layout", wall)})
        return fa

    # --- not yet ported --------------------------------------------------
    def build_consensus(self, n_workers: int | None = None) -> str:
        raise not_ported("stage 4 (mapping + consensus, --with-consensus)",
                         "queue 1, stage 4")

    def run_multihost(self, reads_list: str, with_consensus: bool = False):
        raise not_ported("the multihost pipeline (--multihost)",
                         "queue 1, flag paths")

    def run_draft(self, reads=None, reads_list: str | None = None) -> str:
        """Stages 0-3: reads -> draft p_ctg.fa."""
        self.build_db(reads, reads_list)
        self.build_shimmer_index()
        self.build_overlaps()
        return self.build_contigs()
