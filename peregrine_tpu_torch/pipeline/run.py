"""Assembly pipeline orchestrator, stages 0-4.

The port of peregrine_tpu/pipeline/run.py.  Stages
run in-process with file-checkpointed outputs in the reference's
directory layout, byte-identical to the JAX package's, so either package
resumes the other's output directory:

    0-seqdb/   seq_dataset.seqdb + .idx
    1-index/   shmr-L{level}-*.dat + MC files (and L0 with keep_l0)
    2-ovlp/    preads.ovl
    3-asm/     sg_edges_list, utg_data, ctg_paths, p_ctg_tiling_path, p_ctg.fa
    4-cns/     ctg.seqdb, read_map.txt, p_ctg_cns.fa (4-cns-alt/ with_alt)

Stage 1 and stage 4's contig index run on the given device (the SHIMMER
kernels; a seqdb past the device budget is indexed in read segments);
stages 0, 2 and 3 and stage 4's mapping and consensus are host numpy and
native C++, except where a flag moves stage 2 to the device:
device_pairs builds the pair map there, use_device_aligner aligns the
overlap requests there (the banded Myers kernel), and hybrid_overlap
splits them between a device thread and the host cores.

Several devices: an Assembly holds a mesh (parallel.mesh, by default all
visible cards of its device type, one shard on the CPU).  With cfg.mesh
and more than one shard, stage 1 runs over it (build_index_mesh) and so
does the pair map (build_pairs_mesh, where the mesh lives wholly in this
process); with cfg.shard_overlap the seqdb is split over it for the
device aligner (--shard-overlap).  run_multihost runs the pipeline in
several processes over torch.distributed (--multihost): stage 1 over
the global mesh, the overlap rounds and the consensus windows split
between the ranks through files in the output directory.  Every output
is byte-identical to the single-device run.
"""

from __future__ import annotations

import contextlib
import logging
import os
import resource
import threading

import numpy as np
import torch

from .. import trace
from ..config import AsmConfig
from ..graph.contig import tiling_to_contigs
from ..graph.layout import assemble_graph
from ..graph.string_graph import generate_string_graph
from ..graph.tiling import tiling_paths
from ..io.seqdb import SeqDB, read_fastx
from ..ops.index import ShimmerIndex, build_index, build_index_segmented
from ..ops.kernels import require_device
from ..ops.overlap import overlap_all, write_ovl_file
from ..parallel.mesh import Mesh, make_mesh

log = logging.getLogger("peregrine_tpu_torch")

# Batching/padding knobs that change execution shape but not outputs; a
# resume may differ on these without invalidating stage checkpoints.
_NON_SEMANTIC_CFG_FIELDS = frozenset(
    {"sketch_pad_len", "sketch_batch", "aln_batch", "aln_max_len",
     "spill_dir", "device_pairs"})


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


def _device_db_budget(device: torch.device, cfg: AsmConfig,
                      held: int = 0) -> int:
    """Max seqdb bytes whose packed planes (~0.375x the seqdb bytes) may
    be resident on the device at once; PG_HBM_DB_BUDGET (seqdb bytes)
    overrides.  On a card: the seqdb size whose planes take a quarter of
    the free device memory, leaving the rest to the index batches, where
    the `held` bytes (planes already resident) count as free.  The CPU
    device has no such limit.  With cfg.device_pairs the device also
    holds the pair map's sort workspace, so the budget is 60% of that, as
    in the JAX package."""
    env = os.environ.get("PG_HBM_DB_BUDGET")
    if env:
        b = int(env)
    elif device.type != "cuda":
        return 1 << 62
    else:
        free, _ = torch.cuda.mem_get_info(device)
        b = int((free + held) / 4 / 0.375)
    return int(b * 0.6) if cfg.device_pairs else b


def _manifest_bytes(reads_list: str) -> int:
    """The summed sizes of a manifest's read files: at least their bases
    for plain FASTA/FASTQ (0 for a file that cannot be read)."""
    total = 0
    with open(reads_list) as f:
        for line in f:
            path = line.strip()
            if path:
                try:
                    total += os.path.getsize(path)
                except OSError:
                    pass
    return total


def _stage0_upload(device: torch.device, cfg: AsmConfig, mesh: Mesh,
                   est_bytes: int) -> bool:
    """Whether stage 0 packs and uploads the seqdb while it encodes
    (SeqDBUploader), as the JAX package does on an accelerator: on a card,
    unless stage 1 runs over a mesh of several shards, and where the
    manifest's bytes fit the device budget (a larger seqdb is indexed in
    segments, each uploading only its bytes)."""
    return (device.type == "cuda" and not (cfg.mesh and mesh.n > 1)
            and est_bytes <= _device_db_budget(device, cfg))


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

    Each stage runs under a span (peregrine_tpu_torch.trace) carrying the
    assembly's id, its parts under child spans; the stage's log record
    carries `stage_wall` = (stage, its span's seconds) for callers that
    collect stage walls (chip_smoke.py, pgbench)."""

    def __init__(self, outdir: str, cfg: AsmConfig = AsmConfig(),
                 device="cuda", with_alt: bool = False,
                 profile_dir: str | None = None,
                 on_config_change: str = "error", mesh: Mesh | None = None):
        """device: where stage 1 runs ("cuda" or "cpu"; no fallback).
        mesh: the shards that cfg.mesh and cfg.shard_overlap spread work
        over (default make_mesh(device)); a mesh of one shard takes the
        single-device path.
        profile_dir: run() writes a torch.profiler trace of itself here.
        on_config_change: when outdir holds checkpoints written under a
        semantically different AsmConfig — "error" (refuse), "clean"
        (invalidate stages 1-4 and re-run), or "ignore"."""
        assert on_config_change in ("error", "clean", "ignore")
        self.device = require_device(device)
        self.asm_id = trace.new_assembly()
        self.mesh = mesh if mesh is not None else make_mesh(self.device)
        self.outdir = outdir
        self.cfg = cfg
        self.with_alt = with_alt
        self.profile_dir = profile_dir
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
        # tmp + rename: the ranks of a multi-process run construct their
        # Assembly over one directory at once, and a rank that read a
        # peer's half-written config.json would refuse it as a mismatch
        tmp = f"{cfg_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(cfg.to_json())
        os.replace(tmp, cfg_path)
        self.db: SeqDB | None = None
        self.idx: ShimmerIndex | None = None
        self._save_thread = None  # async stage-0 checkpoint write
        self._pairs = None        # read pair map shared by stages 2 and 4
        # stage 0's seqdb upload to the card, which stage 1 takes; off for
        # run_multihost, whose stage 1 runs over the global mesh
        self._uploader = None
        self._stage0_upload = True

    def _invalidate_stages(self) -> None:
        """Remove config-dependent stage checkpoints (1-index through 4-cns
        and the alt-polish dir); the stage-0 seqdb only depends on the reads."""
        import shutil
        for d in ("1-index", "2-ovlp", "3-asm", "4-cns", "4-cns-alt"):
            p = os.path.join(self.outdir, d)
            if os.path.isdir(p):
                shutil.rmtree(p)

    # --- stage 0: sequence database ------------------------------------
    def build_db(self, reads=None, reads_list: str | None = None,
                 reads_iter=None) -> SeqDB:
        prefix = os.path.join(self.outdir, "0-seqdb", "seq_dataset")
        if _stage_done(prefix + ".idx") and reads is None:
            self.db = SeqDB.open(prefix)
        elif reads_iter is not None:
            # an in-process (name, seq) stream: the same bounded-RSS disk
            # build, with no FASTA on disk
            with self._stage("seqdb") as sp, trace.span("seqdb.encode"):
                self.db = SeqDB.build_to_disk_from_iter(reads_iter, prefix)
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs streamed "
                     "to disk; peak RSS %.1f GB)", len(self.db),
                     int(self.db.lengths.sum()), sp.seconds, _peak_rss_gb(),
                     extra={"stage_wall": ("seqdb", sp.seconds)})
        elif reads is None:
            # manifest input streams straight to disk: peak RSS is one
            # read + the write buffer; the pipeline then reads back
            # through a page-cache-governed memmap.  On a card the seqdb
            # is packed and uploaded on a worker thread as it is encoded
            # (the chunk sink), and stage 1 takes the planes.
            with self._stage("seqdb") as sp:
                sink, started = None, ""
                est = _manifest_bytes(reads_list)
                # the budget check reads the card's free memory: in a new
                # process that call makes the CUDA context
                with trace.span("seqdb.upload_start") as up_sp:
                    if self._stage0_upload and _stage0_upload(
                            self.device, self.cfg, self.mesh, est):
                        from ..ops.dbgather import SeqDBUploader
                        self._uploader = SeqDBUploader(self.device,
                                                       est_bases=est)
                if self._uploader is not None:
                    sink = self._uploader.feed
                    started = "; seqdb upload to %s started in %.3fs" % (
                        self._uploader.device, up_sp.t1 - sp.t0)
                with trace.span("seqdb.encode"):
                    self.db = SeqDB.build_to_disk(reads_list, prefix,
                                                  chunk_sink=sink)
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs streamed "
                     "to disk; peak RSS %.1f GB%s)", len(self.db),
                     int(self.db.lengths.sum()), sp.seconds, _peak_rss_gb(),
                     started, extra={"stage_wall": ("seqdb", sp.seconds)})
        else:
            with self._stage("seqdb") as sp:
                with trace.span("seqdb.encode"):
                    self.db = SeqDB.from_reads(reads)
                # the checkpoint write overlaps the index stage; save()
                # writes .seqdb before .idx, and resume trusts .idx
                self._save_thread = threading.Thread(
                    target=self.db.save, args=(prefix,), name="seqdb-save")
                self._save_thread.start()
            log.info("stage 0 seqdb: %d reads, %d bases (%.1fs; "
                     "checkpoint writes in background)",
                     len(self.db), int(self.db.lengths.sum()), sp.seconds,
                     extra={"stage_wall": ("seqdb", sp.seconds)})
        return self.db

    def _stage(self, name: str, **attrs):
        """A span opened with this assembly's id: its stages' spans."""
        return trace.span(name, asm=self.asm_id, **attrs)

    # --- stage 1: SHIMMER index ----------------------------------------
    def build_shimmer_index(self, keep_l0: bool = False) -> ShimmerIndex:
        """Stage 1; keep_l0 (--with-L0-index) also writes the level-0
        index, shmr-L0-*.dat, and resumes only when both levels exist.
        A seqdb past the device budget is indexed in read segments, each
        uploading only its bytes; with keep_l0 it is one build, as in the
        JAX package."""
        prefix = os.path.join(self.outdir, "1-index", "shmr")
        level = self.cfg.levels
        mm = f"{prefix}-L{level}-01-of-01.dat"
        mc = f"{prefix}-L{level}-MC-01-of-01.dat"
        with self._stage("index") as sp:
            # stage 0's planes serve the single build alone: dropped
            # before a resume, the mesh build and the segmented build
            packed, took = self._stage0_planes()
            if _stage_done(mm) and (not keep_l0 or _stage_done(
                    f"{prefix}-L0-MC-01-of-01.dat")):
                del packed
                self.idx = ShimmerIndex.load_chunks([mm], [mc])
                return self.idx
            held = sum(p.numel() for p in packed) if packed else 0
            budget = _device_db_budget(self.device, self.cfg, held)
            on_mesh = self.cfg.mesh and self.mesh.n > 1 and not keep_l0
            segmented = (not on_mesh and not keep_l0
                         and self.db.data.nbytes > budget)
            if packed is not None and (on_mesh or segmented):
                packed, took = None, "; the stage-0 seqdb planes dropped"
            if on_mesh:
                from ..parallel.sharded_index import build_index_mesh
                self.idx, l0 = build_index_mesh(self.db, self.cfg,
                                                self.mesh), None
            elif segmented:
                log.info("stage 1: the %.1f GB seqdb exceeds the %.1f GB "
                         "device budget: indexing in segments",
                         self.db.data.nbytes / (1 << 30), budget / (1 << 30))
                self.idx, l0 = build_index_segmented(
                    self.db, self.cfg, self.device, budget), None
            else:
                built = build_index(self.db, self.cfg, self.device,
                                    packed=packed, keep_l0=keep_l0)
                self.idx, l0 = built if keep_l0 else (built, None)
            del packed
            with trace.span("index.save"):
                self.idx.save(prefix, level=level)
                if keep_l0:
                    l0.save(prefix, level=0)
        log.info("stage 1 index: %d SHIMMERs, %d distinct%s (%.1fs on "
                 "%s%s; peak RSS %.1f GB%s)",
                 len(self.idx.x), len(self.idx.mc_hash),
                 f"; {len(l0.x)} level-0 minimizers" if keep_l0 else "",
                 sp.seconds, self.mesh if on_mesh else self.device, took,
                 _peak_rss_gb(), _device_mem_line(self.device),
                 extra={"stage_wall": ("index", sp.seconds)})
        return self.idx

    def _stage0_planes(self):
        """Finish stage 0's seqdb upload, where it started one: returns
        (planes or None, the log's note of them).  An uploader that failed
        raises here; there is no second upload to fall back on."""
        up, self._uploader = self._uploader, None
        if up is None:
            return None, ""
        with trace.span("index.planes_wait") as sp:
            packed = up.finish()
        st = up.stats
        return packed, (
            "; took the stage-0 seqdb planes: finish() waited %.3fs, %d B "
            "copied, %d B of amb elided, planes' peak %d B, worker set-up "
            "%.3fs, pack %.3fs" % (
                sp.seconds, st["copied_bytes"], st["elided_bytes"],
                st["peak_plane_bytes"], st["init_s"], st["pack_s"]))

    def _pair_map(self):
        """The unchunked oriented read pair map, shared by stages 2 and 4:
        built over the mesh with cfg.mesh (where it has several shards,
        all in this process), on the device with cfg.device_pairs, else
        by the host build; all byte-identical."""
        if self._pairs is None:
            self._maybe_auto_spill()
            with trace.span("overlap.pairs") as sp:
                if (self.cfg.mesh and self.mesh.n > 1
                        and self.mesh.group is None):
                    from ..parallel.sharded_pairs import build_pairs_mesh
                    self._pairs, _ = build_pairs_mesh(
                        self.idx, self.db.lengths, self.mesh,
                        self.cfg.mc_lower, self.cfg.mc_upper,
                        self.cfg.min_anchor_dist, self.cfg.ovlp_upper)
                elif self.cfg.device_pairs:
                    from ..ops.device_pairs import build_pairs_device
                    self._pairs, _ = build_pairs_device(
                        self.idx, self.db.lengths, self.device,
                        self.cfg.mc_lower, self.cfg.mc_upper,
                        self.cfg.min_anchor_dist, self.cfg.ovlp_upper)
                else:
                    from ..ops.overlap import build_pairs
                    self._pairs = build_pairs(
                        self.idx, self.db.lengths, 1, 1, self.cfg.mc_lower,
                        self.cfg.mc_upper, self.cfg.min_anchor_dist,
                        spill_dir=self.cfg.spill_dir)
                sp.attrs["entries"] = len(self._pairs[0])
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
        if _stage_done(path):
            return path
        with self._stage("overlap") as sp:
            ovlps = self._overlaps(n_chunks, n_workers)
            with trace.span("overlap.write") as wsp:
                n_rows = wsp.attrs["rows"] = write_ovl_file(path, ovlps)
        spill_line = ""
        if self.cfg.spill_dir is not None:
            spill_line = (", spill free %.1f GB"
                          % (_spill_free_bytes(self.cfg.spill_dir)
                             / (1 << 30)))
        log.info("stage 2 overlap: %d records -> %d rows (%.1fs; "
                 "peak RSS %.1f GB, anon %.1f GB%s%s)",
                 len(ovlps), n_rows, sp.seconds, _peak_rss_gb(),
                 _anon_rss_gb(), _device_mem_line(self.device),
                 spill_line, extra={"stage_wall": ("overlap", sp.seconds)})
        return path

    def _overlaps(self, n_chunks: int | None, n_workers: int | None):
        """Stage 2's overlap records, from the backend the config picks."""
        self._maybe_auto_spill()
        if self.cfg.spill_dir is not None and self.db is not None:
            # explicit --spill-dir: same capacity gate auto-spill gets
            os.makedirs(self.cfg.spill_dir, exist_ok=True)
            _preflight_spill(self.cfg.spill_dir,
                             int(0.22 * self.db.data.nbytes),
                             "overlap stage spill")
        dedup = self.cfg.dedup_overlap
        if self.cfg.use_device_aligner or self.cfg.hybrid_overlap:
            log.warning(
                "non-host overlap backend: the device Myers kernel "
                "reports optimal distances where the host aligner is "
                "greedy, so accept decisions differ slightly (~97.5% "
                "pair agreement); output is not byte-identical to the "
                "host backend")
        if self.cfg.hybrid_overlap and dedup:
            # chunk-free hybrid: host threads + a device thread pull
            # slices of ONE globally-deduplicated request array
            from ..ops.overlap import overlap_all_spec
            ovlps = overlap_all_spec(
                self.db, self.idx, self.cfg,
                n_workers=n_workers or (os.cpu_count() or 1),
                backend="hybrid", pairs=self._pair_map(),
                device=self.device)
        elif self.cfg.hybrid_overlap:
            from ..ops.overlap import overlap_all_hybrid
            if self.device.type == "cpu":
                log.warning("hybrid overlap on the cpu device: its "
                            "device thread runs the plain aligner")
            n_workers = n_workers or (os.cpu_count() or 1)
            # one chunk per worker thread (host threads + the device
            # thread): every EXTRA chunk duplicates a share of a
            # chunk's alignments (per-chunk rid-pair dedup)
            ovlps = overlap_all_hybrid(
                self.db, self.idx, self.cfg, self.device,
                n_chunks=n_chunks or (n_workers + 1),
                n_host_workers=n_workers)
        elif self.cfg.use_device_aligner and dedup \
                and not self.cfg.shard_overlap:
            from ..ops.overlap import overlap_all_spec
            ovlps = overlap_all_spec(self.db, self.idx, self.cfg,
                                     n_workers=n_workers,
                                     backend="device",
                                     pairs=self._pair_map(),
                                     device=self.device)
        elif dedup and self.cfg.spill_dir is not None \
                and not self.cfg.shard_overlap:
            # low-memory mode: sharing the stage-2/stage-4 pair map
            # pins its spill file on disk across stages 2-4, on top of
            # the replay stream and result arena the overlap rounds
            # spill.  Share it only when the spill filesystem has that
            # headroom; otherwise overlap_all_spec builds and frees
            # its own copy and stage 4 rebuilds it.
            from ..ops.overlap import overlap_all_spec
            free = _spill_free_bytes(self.cfg.spill_dir)
            # the JAX package's rule: pinning the map costs ~0.13x db
            # of disk, on top of ~0.11x transient spill and ~0.25x of
            # stage-3/4 outputs still to come -- require 0.55x db free
            keep_map = free >= int(0.55 * self.db.data.nbytes)
            log.info("overlap spill mode: %s the stage-2/4 pair map "
                     "(spill free %.1f GB vs %.1f GB to keep it)",
                     "sharing" if keep_map else "not sharing",
                     free / (1 << 30),
                     0.55 * self.db.data.nbytes / (1 << 30))
            ovlps = overlap_all_spec(
                self.db, self.idx, self.cfg,
                n_workers=n_workers or (os.cpu_count() or 1),
                backend="host",
                pairs=self._pair_map() if keep_map else None)
        elif self.cfg.use_device_aligner:
            from ..ops.overlap import overlap_chunk_device
            if n_chunks or n_workers:
                log.warning("device aligner runs in-process; "
                            "n_chunks/n_workers ignored")
            ovlps = overlap_chunk_device(self.db, self.idx, self.cfg,
                                         self.device, mesh=self.mesh)
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
        return ovlps

    # --- stage 3: layout + draft contigs --------------------------------
    def build_contigs(self) -> str:
        asm = os.path.join(self.outdir, "3-asm")
        fa = os.path.join(asm, "p_ctg.fa")
        if _stage_done(fa):
            return fa
        with self._stage("layout") as sp:
            contigs = self._layout(asm, fa)
        log.info("stage 3 layout: %d contigs, %d bases (%.1fs; "
                 "peak RSS %.1f GB)",
                 len(contigs), sum(len(s) for _, s in contigs), sp.seconds,
                 _peak_rss_gb(), extra={"stage_wall": ("layout", sp.seconds)})
        return fa

    def _layout(self, asm: str, fa: str) -> list:
        """Stage 3's work, each part under its span; returns the primary
        contigs, written to fa."""
        with trace.span("layout.string_graph"):
            with open(os.path.join(self.outdir, "2-ovlp", "preads.ovl"),
                      "rb") as f:
                result = generate_string_graph(
                    ovl_bytes=f.read(), min_len=self.cfg.min_len,
                    min_idt=self.cfg.min_idt, lfc=self.cfg.lfc,
                    disable_chimer_bridge_removal=(
                        self.cfg.disable_chimer_bridge_removal))
        with trace.span("layout.graph"):
            sg_path = os.path.join(asm, "sg_edges_list")
            if result.sg_edge_bytes is not None:
                with open(sg_path + ".tmp", "wb") as f:
                    f.write(result.sg_edge_bytes)
                os.replace(sg_path + ".tmp", sg_path)
            else:
                _write_lines(sg_path, result.sg_edge_lines)
            _write_lines(os.path.join(asm, "chimers_nodes"),
                         result.chimer_nodes)

            u_edge_data, ctg_rows, utg_rows, compound_rows = \
                assemble_graph(result)
            _write_lines(os.path.join(asm, "utg_data"), utg_rows)
            _write_lines(os.path.join(asm, "ctg_paths"), ctg_rows)
            _write_lines(os.path.join(asm, "c_path"), compound_rows)

        with trace.span("layout.tiling"):
            p_lines, a_lines = tiling_paths(
                result.sg_edge_lines, utg_rows, ctg_rows,
                edge_data=result.tiling_edge_data())
            _write_lines(os.path.join(asm, "p_ctg_tiling_path"), p_lines)
            _write_lines(os.path.join(asm, "a_ctg_tiling_path"), a_lines)

        with trace.span("layout.contigs"):
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
        return contigs

    # --- stage 4: mapping + consensus polish ----------------------------
    def build_consensus(self, n_workers: int | None = None) -> str:
        """Stage 4 under the span polish (no stage wall of its own: its
        parts log theirs)."""
        with self._stage("polish"):
            out = self._polish("p_ctg.fa", "4-cns", "p_ctg_cns.fa",
                               n_workers)
            if self.with_alt:
                # alt-contig polish pass: the reference reruns the
                # consensus stage against a_ctg.fa when it is non-trivial
                # (>500 kB) (py/scripts/pg_run.py:622-633)
                a_fa = os.path.join(self.outdir, "3-asm", "a_ctg.fa")
                if (os.path.exists(a_fa) and os.stat(a_fa).st_size
                        > self.cfg.alt_cns_min_size):
                    self._polish("a_ctg.fa", "4-cns-alt", "a_ctg_cns.fa",
                                 n_workers)
        self._pairs = None  # free the shared pair map (GBs at scale)
        return out

    def _polish(self, ctg_fa: str, cns_subdir: str, out_name: str,
                n_workers: int | None = None) -> str:
        """Polish one contig file: its SHIMMER index on the device, the
        reads mapped to it, and the window consensus.  Log records carry
        stage walls ctg_index, mapping and consensus (alt_* for the alt
        pass), each its span's seconds."""
        from ..native import write_rows
        from ..ops.consensus import consensus_windows, plan_all, stitch_all
        from ..ops.mapping import map_reads_to_ref, map_reads_to_ref_grouped

        cns_dir = os.path.join(self.outdir, cns_subdir)
        os.makedirs(cns_dir, exist_ok=True)
        out_fa = os.path.join(cns_dir, out_name)
        if _stage_done(out_fa):
            return out_fa
        tag = "" if cns_subdir == "4-cns" else "alt_"
        ctg_prefix = os.path.join(cns_dir, "ctg")
        with trace.span("polish.ctg_db") as db_sp:
            ctg_db = SeqDB.from_reads(
                read_fastx(os.path.join(self.outdir, "3-asm", ctg_fa)))
            ctg_db.save(ctg_prefix)
        with trace.span(tag + "ctg_index") as sp:
            ctg_idx = build_index(ctg_db, self.cfg, self.device)
        log.info("stage 4 contig index: %d contigs, %d SHIMMERs (ctg db "
                 "%.1fs, index %.1fs on %s%s)%s", len(ctg_db), len(ctg_idx.x),
                 db_sp.seconds, sp.seconds, self.device,
                 _device_mem_line(self.device),
                 "" if self._pairs is not None
                 else "; the pair map is rebuilt next",
                 extra={"stage_wall": (tag + "ctg_index", sp.seconds)})
        # external grouped emission bounds this stage's anonymous peak
        # (the reference's `sort -T tmp -S 8g` analog,
        # py/scripts/pg_run.py:491-496): rows land grouped by contig in
        # a disk-backed memmap; per-contig content and order match the
        # in-memory path, only read_map.txt's row order differs
        external = (os.environ.get("PG_MAP_EXTERNAL") == "1"
                    or self.db.data.nbytes > (8 << 30))
        with trace.span(tag + "mapping") as sp:
            if external:
                mm, offs = map_reads_to_ref_grouped(
                    self.idx, self.db.lengths, ctg_idx, self.cfg,
                    os.path.join(cns_dir, "read_map.npy"), len(ctg_db),
                    pairs=self._pairs)
                np.save(os.path.join(cns_dir, "read_map_offs.npy"), offs)
                write_rows(mm, os.path.join(cns_dir, "read_map.txt"))
                n_rows = len(mm)
                contig_rows = {rid: mm[offs[rid]:offs[rid + 1]]
                               for rid in range(len(ctg_db))}
            else:
                rows = map_reads_to_ref(self.idx, self.db.lengths, ctg_idx,
                                        self.cfg, pairs=self._pairs)
                write_rows(rows.reshape(len(rows), -1),
                           os.path.join(cns_dir, "read_map.txt"))
                n_rows = len(rows)
                contig_rows = {rid: (rows[rows[:, 0] == rid]
                                     if len(rows) else rows)
                               for rid in range(len(ctg_db))}
        log.info("stage 4 mapping: %d rows (%.1fs%s)", n_rows, sp.seconds,
                 "; external grouped" if external else "",
                 extra={"stage_wall": (tag + "mapping", sp.seconds)})

        if n_workers is None:
            # consensus workers are GIL-releasing threads: always parallel
            n_workers = os.cpu_count() or 1
        with trace.span(tag + "consensus") as sp:
            if self._save_thread is not None:
                # the window threads re-open the seqdb from disk
                self._save_thread.join()
                self._save_thread = None
            with trace.span("consensus.plan"):
                read_db = SeqDB.open(
                    os.path.join(self.outdir, "0-seqdb", "seq_dataset"))
                plans = plan_all(contig_rows, ctg_db.lengths, self.cfg)
            results = consensus_windows(read_db, SeqDB.open(ctg_prefix),
                                        plans, self.cfg, n_workers)
            with trace.span("consensus.stitch"):
                seqs = stitch_all(plans, results)
            with trace.span("consensus.write"):
                with open(out_fa + ".tmp", "w") as f:
                    for ctg_rid in range(len(ctg_db)):
                        f.write(f">{ctg_db.names[ctg_rid]}\n"
                                f"{seqs[ctg_rid].decode()}\n")
                os.replace(out_fa + ".tmp", out_fa)
        log.info("stage 4 consensus: %d contigs (%.1fs; peak RSS %.1f GB, "
                 "anon %.1f GB)", len(ctg_db), sp.seconds, _peak_rss_gb(),
                 _anon_rss_gb(),
                 extra={"stage_wall": (tag + "consensus", sp.seconds)})
        return out_fa

    def run_draft(self, reads=None, reads_list: str | None = None) -> str:
        """Stages 0-3: reads -> draft p_ctg.fa."""
        self.build_db(reads, reads_list)
        self.build_shimmer_index()
        self.build_overlaps()
        return self.build_contigs()

    def run(self, reads=None, reads_list: str | None = None,
            with_consensus: bool = True) -> str:
        """The whole pipeline, under the profiler when profile_dir is set;
        returns the final fasta path."""
        with profiled(self.profile_dir, self.device):
            fa = self.run_draft(reads, reads_list)
            if with_consensus:
                fa = self.build_consensus()
        return fa

    # --- several processes (--multihost) ---------------------------------
    def _mh_overlap(self, rank: int, nranks: int, barrier) -> None:
        """Stage 2 with the alignment rounds split between the ranks.

        Every rank runs the same deterministic collect loop
        (overlap_all_spec); rank r aligns only its block-cyclic share of
        each round's requests, the results travel through exchange files
        in the output directory with a barrier a round, every rank merges
        the same full result set, and the final exact replay runs on rank
        0 alone, so preads.ovl is byte-identical to the single-process
        run at any rank count."""
        from ..ops.overlap import overlap_all_spec

        path = os.path.join(self.outdir, "2-ovlp", "preads.ovl")
        xdir = os.path.join(self.outdir, "2-ovlp", "xchg")
        os.makedirs(xdir, exist_ok=True)
        self._maybe_auto_spill()

        def exchange(rnd: int, reqs, res, mine):
            my_idx = np.flatnonzero(mine)
            p = os.path.join(xdir, f"res-r{rnd}-p{rank}.npz")
            np.savez(p + ".tmp.npz", idx=my_idx, res=res[my_idx],
                     n=np.int64(len(res)))
            os.replace(p + ".tmp.npz", p)
            barrier(f"pg-tpu ovl-xchg-{rnd}")
            for r in range(nranks):
                if r == rank:
                    continue
                with np.load(os.path.join(
                        xdir, f"res-r{rnd}-p{r}.npz")) as d:
                    if int(d["n"]) != len(res):
                        raise RuntimeError(
                            f"overlap exchange round {rnd}: rank {r} "
                            f"collected {int(d['n'])} requests vs local "
                            f"{len(res)}: the ranks diverged")
                    res[d["idx"]] = d["res"]
            return res

        with self._stage("overlap") as sp:
            ovlps = overlap_all_spec(
                self.db, self.idx, self.cfg, n_workers=os.cpu_count() or 1,
                backend="host", pairs=None, shard=(rank, nranks),
                exchange=exchange, run_final=(rank == 0))
            # every rank has read the last round's files before rank 0
            # removes them
            barrier("pg-tpu ovl-xchg-done")
            if rank == 0:
                with trace.span("overlap.write") as wsp:
                    n_rows = wsp.attrs["rows"] = write_ovl_file(path, ovlps)
        if rank == 0:
            log.info("stage 2 overlap [multihost x%d]: %d records -> %d "
                     "rows (%.1fs on rank 0)", nranks, len(ovlps), n_rows,
                     sp.seconds, extra={"stage_wall": ("overlap",
                                                       sp.seconds)})
            import shutil
            shutil.rmtree(xdir, ignore_errors=True)

    def _mh_consensus(self, rank: int, nranks: int, barrier,
                      n_workers: int | None = None) -> str:
        """Stage 4 with the consensus windows split by job index % nranks.
        Rank 0 maps the reads to the contigs (read_map.npy and
        read_map_offs.npy in 4-cns), every rank computes its share of the
        windows, the segments travel through exchange files, and rank 0
        stitches and writes p_ctg_cns.fa, byte-identical to the
        single-process consensus."""
        import pickle

        from ..ops.consensus import consensus_windows, plan_all, stitch_all

        cns_dir = os.path.join(self.outdir, "4-cns")
        out_fa = os.path.join(cns_dir, "p_ctg_cns.fa")
        if _stage_done(out_fa):
            return out_fa
        if rank == 0:
            self._ensure_mapping()
        barrier("pg-tpu stage4-map")

        with self._stage("consensus") as sp:
            with trace.span("consensus.plan"):
                ctg_db = SeqDB.open(os.path.join(cns_dir, "ctg"))
                mm = np.load(os.path.join(cns_dir, "read_map.npy"),
                             mmap_mode="r")
                offs = np.load(os.path.join(cns_dir, "read_map_offs.npy"))
                contig_rows = {rid: mm[offs[rid]:offs[rid + 1]]
                               for rid in range(len(ctg_db))}
                plans = plan_all(contig_rows, ctg_db.lengths, self.cfg)
            if self._save_thread is not None:
                # the window threads re-open the seqdb from disk
                self._save_thread.join()
                self._save_thread = None
            read_db = SeqDB.open(
                os.path.join(self.outdir, "0-seqdb", "seq_dataset"))
            part = consensus_windows(read_db, ctg_db, plans, self.cfg,
                                     n_workers or os.cpu_count() or 1,
                                     shard=(rank, nranks))
        n_windows = sum(len(s) for s in plans.values())
        log.info("stage 4 consensus [multihost]: rank %d computed %d of "
                 "%d windows (%.1fs)", rank, len(part), n_windows,
                 sp.seconds)
        xdir = os.path.join(cns_dir, "xchg")
        os.makedirs(xdir, exist_ok=True)
        p = os.path.join(xdir, f"cns-p{rank}.pkl")
        with open(p + ".tmp", "wb") as f:
            pickle.dump(part, f)
        os.replace(p + ".tmp", p)
        barrier("pg-tpu stage4-cns")
        if rank != 0:
            return out_fa
        results = dict(part)
        for r in range(1, nranks):
            # written by this run's ranks, in this run's output directory
            with open(os.path.join(xdir, f"cns-p{r}.pkl"), "rb") as f:
                results.update(pickle.load(f))
        seqs = stitch_all(plans, results)
        with open(out_fa + ".tmp", "w") as f:
            for ctg_rid in range(len(ctg_db)):
                f.write(f">{ctg_db.names[ctg_rid]}\n"
                        f"{seqs[ctg_rid].decode()}\n")
        os.replace(out_fa + ".tmp", out_fa)
        import shutil
        shutil.rmtree(xdir, ignore_errors=True)
        log.info("stage 4 consensus done [multihost x%d]", nranks)
        return out_fa

    def _ensure_mapping(self) -> None:
        """The stage-4 mapping (contig seqdb, its index on the device and
        the grouped rows read_map.npy + read_map_offs.npy), unless it is
        on disk already: the shared input of the consensus ranks."""
        from ..ops.mapping import map_reads_to_ref_grouped

        cns_dir = os.path.join(self.outdir, "4-cns")
        os.makedirs(cns_dir, exist_ok=True)
        if _stage_done(os.path.join(cns_dir, "read_map_offs.npy")):
            return
        with self._stage("mapping") as sp:
            ctg_prefix = os.path.join(cns_dir, "ctg")
            with trace.span("polish.ctg_db"):
                ctg_db = SeqDB.from_reads(
                    read_fastx(os.path.join(self.outdir, "3-asm",
                                            "p_ctg.fa")))
                ctg_db.save(ctg_prefix)
            with trace.span("ctg_index"):
                ctg_idx = build_index(ctg_db, self.cfg, self.device)
            mm, offs = map_reads_to_ref_grouped(
                self.idx, self.db.lengths, ctg_idx, self.cfg,
                os.path.join(cns_dir, "read_map.npy"), len(ctg_db),
                pairs=self._pairs)
            tmp = os.path.join(cns_dir, "read_map_offs.npy.tmp.npy")
            np.save(tmp, offs)
            os.replace(tmp, os.path.join(cns_dir, "read_map_offs.npy"))
        log.info("stage 4 mapping: %d rows (%.1fs; external grouped)",
                 len(mm), sp.seconds)

    def run_multihost(self, reads_list: str, with_consensus: bool = False
                      ) -> str | None:
        """The pipeline in several processes sharing the output directory,
        one rank each of the torch.distributed group that
        parallel.distributed.init_distributed joined (one process, rank 0
        of 1, without a group):

          0 seqdb    rank 0
          1 index    every rank over the global mesh, one shard a rank
                     (data-parallel sketch, hash exchange, replicated)
          2 overlap  every rank: the alignment rounds split block-
                     cyclically (_mh_overlap); final replay on rank 0
          3 layout   rank 0
          4 mapping  rank 0; the consensus windows split between every
                     rank (_mh_consensus)

        Every stage output is byte-identical to the single-process run at
        any rank count.  Returns the final fasta path on rank 0, None
        elsewhere."""
        from ..parallel import distributed
        from ..parallel.sharded_index import build_index_mesh

        rank, nranks = distributed.rank(), distributed.world_size()
        primary = rank == 0
        barrier = distributed.barrier
        if primary:
            self._stage0_upload = False
            self.build_db(reads_list=reads_list)
        barrier("pg-tpu stage0")
        if not primary:
            self.db = SeqDB.open(
                os.path.join(self.outdir, "0-seqdb", "seq_dataset"))

        prefix = os.path.join(self.outdir, "1-index", "shmr")
        level = self.cfg.levels
        mm = f"{prefix}-L{level}-01-of-01.dat"
        if _stage_done(mm):
            self.idx = ShimmerIndex.load_chunks(
                [mm], [f"{prefix}-L{level}-MC-01-of-01.dat"])
        else:
            with self._stage("index") as sp:
                mesh = distributed.global_mesh(self.device)
                self.idx = build_index_mesh(self.db, self.cfg, mesh)
                if primary:
                    with trace.span("index.save"):
                        self.idx.save(prefix, level=level)
            if primary:
                log.info("stage 1 index [multihost x%d over %s]: %d "
                         "SHIMMERs (%.1fs)", nranks, mesh, len(self.idx.x),
                         sp.seconds, extra={"stage_wall": ("index",
                                                           sp.seconds)})
        barrier("pg-tpu stage1")

        if not _stage_done(os.path.join(self.outdir, "2-ovlp",
                                        "preads.ovl")):
            if nranks > 1:
                self._mh_overlap(rank, nranks, barrier)
            elif primary:
                self.build_overlaps()
        barrier("pg-tpu stage2")

        fa = None
        if primary:
            fa = self.build_contigs()
        barrier("pg-tpu stage3")

        if with_consensus:
            if nranks > 1:
                out = self._mh_consensus(rank, nranks, barrier)
                if primary:
                    fa = out
            elif primary:
                fa = self.build_consensus()
        barrier("pg-tpu final")
        return fa if primary else None


@contextlib.contextmanager
def profiled(profile_dir: str | None, device: torch.device):
    """A torch.profiler trace of the block, written into profile_dir by
    tensorboard_trace_handler (nothing without a directory).  On a cuda
    device it traces the host and the card, and raises where the profiler
    cannot trace the card (no CUPTI) rather than trace the host alone; on
    the cpu device it traces the host.  Shapes, stacks and memory are not
    recorded: a whole run's trace holds ~10^5 device events."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("--profile-dir: torch.profiler cannot trace "
                               "the CUDA device here (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield


def assemble(reads=None, reads_list: str | None = None, outdir: str = "./wd",
             cfg: AsmConfig = AsmConfig(), device="cuda") -> str:
    """One-call draft assembly; returns the p_ctg.fa path."""
    return Assembly(outdir, cfg, device=device).run_draft(reads, reads_list)
