"""Command-line interface of the PyTorch port (the reference pg_run.py
equivalent, with the verbs of pg-tpu).

    pg-tpu-torch asm reads.lst --output ./wd --with-consensus
    pg-tpu-torch asm reads.lst --shimmer-k 28 --with-L0-index --with-consensus
    pg-tpu-torch asm reads.lst --device-aligner --device-pairs
    pg-tpu-torch asm reads.lst --profile-dir prof
    pg-tpu-torch asm reads.lst --mesh --shard-overlap
    torchrun --nproc-per-node 4 -m peregrine_tpu_torch.cli asm reads.lst --multihost
    pg-tpu-torch map ref_prefix read_prefix --output rows.txt
    pg-tpu-torch seqdb reads.lst prefix
    pg-tpu-torch dump-index wd/1-index/shmr-L2-01-of-01.dat --limit 10
    pg-tpu-torch stats wd
    pg-tpu-torch gather-mc a-MC-01-of-02.dat b-MC-02-of-02.dat --output all.dat

The verbs, flags, defaults and printed output are those of pg-tpu, plus
--device on asm and map (default cuda; there is no quiet switch to the
CPU: pass --device cpu to run the device work, the SHIMMER indexes and,
with --device-aligner, --hybrid-overlap or --device-pairs, the stage-2
work, on the host).  seqdb, dump-index, stats and gather-mc are host
code.  --profile-dir writes a torch.profiler trace of the run.

Several cards: --mesh spreads stage 1 and the pair map over every visible
card of one process, and --shard-overlap splits the seqdb over them for
the device aligner.  --multihost runs one process a card under torchrun
(torch.distributed: NCCL for cuda, gloo for cpu); rank 0 prints the
fasta path.  Without a torchrun environment --multihost runs as one
process.  NCCL takes one rank a card; ranks that share a card run
Assembly.run_multihost after parallel.distributed.init_distributed(
backend="gloo").
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

def main(argv=None) -> int:
    from .config import DEFAULT

    p = argparse.ArgumentParser(
        prog="pg-tpu-torch",
        description="OLC assembler for accurate long reads (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    asm = sub.add_parser("asm", help="assemble reads into contigs")
    asm.add_argument("reads_lst", help="file listing FASTA/FASTQ(.gz) read files")
    asm.add_argument("--output", default="./wd", help="output directory")
    asm.add_argument("--device", default="cuda",
                     help="torch device for the device stages (cuda or cpu)")
    asm.add_argument("--with-consensus", action="store_true",
                     help="polish draft contigs with read consensus")
    # defaults come from AsmConfig, the single source of truth
    asm.add_argument("--shimmer-k", type=int, default=DEFAULT.k, dest="k")
    asm.add_argument("--shimmer-w", type=int, default=DEFAULT.w, dest="w")
    asm.add_argument("--shimmer-r", type=int, default=DEFAULT.r, dest="r")
    asm.add_argument("--shimmer-l", type=int, default=DEFAULT.levels,
                     dest="levels", help="SHIMMER reduction levels (1 or 2)")
    asm.add_argument("--best_n_ovlp", type=int, default=DEFAULT.best_n_ovlp)
    asm.add_argument("--mc_lower", type=int, default=DEFAULT.mc_lower)
    asm.add_argument("--mc_upper", type=int, default=DEFAULT.mc_upper)
    asm.add_argument("--aln_bw", type=int, default=DEFAULT.aln_bw)
    asm.add_argument("--ovlp_upper", type=int, default=DEFAULT.ovlp_upper)
    asm.add_argument("--min_len", type=int, default=DEFAULT.min_len)
    asm.add_argument("--min_idt", type=float, default=DEFAULT.min_idt)
    asm.add_argument("--lfc", action="store_true",
                     help="local-flow-consistency repeat resolution")
    asm.add_argument("--disable_chimer_bridge_removal", action="store_true")
    asm.add_argument("--with-alt", action="store_true",
                     help="emit alternate (bubble) contigs a_ctg.fa")
    asm.add_argument("--with-L0-index", action="store_true", dest="with_l0",
                     help="also write the level-0 SHIMMER index")
    asm.add_argument("--n_chunks", type=int, default=None,
                     help="overlap hash chunks (default: auto)")
    asm.add_argument("--n_workers", type=int, default=None,
                     help="overlap/consensus worker threads (default: auto)")
    asm.add_argument("--device-aligner", action="store_true",
                     help="run overlap confirmation on the device (batched "
                          "banded Myers) instead of host cores.  NOTE: the "
                          "device kernel reports optimal edit distances where "
                          "the host aligner is greedy, so accept decisions "
                          "differ slightly (~97.5%% pair agreement with the "
                          "host backend; contig-level output is equivalent "
                          "but not byte-identical)")
    asm.add_argument("--hybrid-overlap", action="store_true",
                     help="align overlaps on the device and host cores "
                          "concurrently (work-stealing queue).  Same "
                          "output caveat as --device-aligner")
    asm.add_argument("--device-pairs", action="store_true",
                     help="build the overlap pair map on the device (byte-"
                          "identical output)")
    asm.add_argument("--shard-overlap", action="store_true",
                     help="shard the seqdb across all devices and route "
                          "alignment requests between them (for dbs larger "
                          "than one card's memory); implies --device-aligner")
    asm.add_argument("--mesh", action="store_true",
                     help="run the index stage sharded over all devices "
                          "(data-parallel sketch + hash all_to_all); output "
                          "is identical to the single-device build")
    asm.add_argument("--multihost", action="store_true",
                     help="run under torch.distributed (launch one process "
                          "per card with torchrun's environment set): rank "
                          "0 executes the host stages and writes outputs, "
                          "every rank executes stage 1 over the global mesh")
    asm.add_argument("--spill-dir", default=None,
                     help="back the overlap pair map / bucket stream with "
                          "unlinked files in this directory instead of "
                          "anonymous memory (output unchanged)")
    asm.add_argument("--mem-budget", default=None,
                     help="host anonymous-memory budget in bytes (e.g. "
                          "32e9) for the overlap stage; spill engages "
                          "automatically past it.  Default: 85%% of "
                          "MemAvailable (equals setting PG_MEM_BUDGET)")
    asm.add_argument("--profile-dir", default=None,
                     help="write a torch.profiler trace of the run here")
    asm.add_argument("--on-config-change", default="error",
                     choices=("error", "clean", "ignore"),
                     help="resuming an outdir built with a different config: "
                          "refuse (error), invalidate stages 1-4 (clean), "
                          "or trust the caller (ignore)")
    asm.add_argument("-v", "--verbose", action="store_true")

    mp = sub.add_parser("map", help="map reads to a reference "
                        "(shmr_map equivalent)")
    mp.add_argument("ref_prefix", help="reference seqdb prefix")
    mp.add_argument("read_prefix", help="read seqdb prefix")
    mp.add_argument("--output", default="-", help="output path (- = stdout)")
    mp.add_argument("--device", default="cuda",
                    help="torch device for the two indexes (cuda or cpu)")
    mp.add_argument("--shimmer-k", type=int, default=16, dest="k")
    mp.add_argument("--shimmer-w", type=int, default=80, dest="w")
    mp.add_argument("--shimmer-r", type=int, default=6, dest="r")
    mp.add_argument("--shimmer-l", type=int, default=2, dest="levels")

    sq = sub.add_parser("seqdb", help="build a packed seqdb from a read list "
                        "(shmr_mkseqdb equivalent)")
    sq.add_argument("reads_lst")
    sq.add_argument("prefix")

    dp = sub.add_parser("dump-index", help="print SHIMMER index records as "
                        "text (py-utils dumper equivalent)")
    dp.add_argument("mmlist", help="a *-L?-cc-of-tt.dat file")
    dp.add_argument("--limit", type=int, default=0)

    st = sub.add_parser("stats", help="summarize a working directory: seqdb "
                        "read stats, SHIMMER index density + multiplicity "
                        "histogram, overlap degree (the process_L2-style "
                        "analyses from the reference's py-utils, as one "
                        "command)")
    st.add_argument("workdir", help="assembly output dir (or a seqdb prefix "
                    "with --prefix)")
    st.add_argument("--prefix", action="store_true",
                    help="treat WORKDIR as a seqdb prefix instead")

    gm = sub.add_parser("gather-mc", help="merge per-chunk minimizer-count "
                        "files (shmr_gather_mc equivalent)")
    gm.add_argument("mc_files", nargs="+", help="*-MC-cc-of-tt.dat files")
    gm.add_argument("--output", required=True, help="merged -MC-all.dat path")

    args = p.parse_args(argv)
    if args.cmd in ("asm", "map") and not 1 <= args.k <= 28:
        p.error(f"--shimmer-k {args.k} outside 1..28 (56-bit hash space)")
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
        format="%(asctime)s %(name)s %(message)s")
    return {"asm": _asm, "map": _map, "seqdb": _seqdb,
            "dump-index": _dump_index, "stats": _stats,
            "gather-mc": _gather_mc}[args.cmd](args)


def _asm(args) -> int:
    from .config import AsmConfig
    from .pipeline.run import Assembly, profiled

    cfg = AsmConfig(
        k=args.k, w=args.w, r=args.r, levels=args.levels,
        best_n_ovlp=args.best_n_ovlp, mc_lower=args.mc_lower,
        mc_upper=args.mc_upper, aln_bw=args.aln_bw,
        ovlp_upper=args.ovlp_upper, min_len=args.min_len,
        min_idt=args.min_idt, lfc=args.lfc,
        disable_chimer_bridge_removal=args.disable_chimer_bridge_removal,
        use_device_aligner=args.device_aligner or args.shard_overlap,
        hybrid_overlap=args.hybrid_overlap, device_pairs=args.device_pairs,
        shard_overlap=args.shard_overlap, mesh=args.mesh,
        spill_dir=args.spill_dir)
    if args.mem_budget is not None:
        os.environ["PG_MEM_BUDGET"] = str(int(float(args.mem_budget)))
    if args.multihost:
        from .parallel import distributed
        distributed.init_distributed(device=args.device)
        try:
            asm_obj = Assembly(args.output, cfg.replace(mesh=True),
                               device=distributed.local_device(args.device),
                               with_alt=args.with_alt,
                               on_config_change=args.on_config_change)
            fa = asm_obj.run_multihost(args.reads_lst,
                                       with_consensus=args.with_consensus)
        finally:
            distributed.shutdown()
        if fa:
            print(fa)
        return 0
    asm_obj = Assembly(args.output, cfg, device=args.device,
                       with_alt=args.with_alt,
                       on_config_change=args.on_config_change)
    with profiled(args.profile_dir, asm_obj.device):
        asm_obj.build_db(reads_list=args.reads_lst)
        asm_obj.build_shimmer_index(keep_l0=args.with_l0)
        asm_obj.build_overlaps(args.n_chunks, args.n_workers)
        fa = asm_obj.build_contigs()
        if args.with_consensus:
            fa = asm_obj.build_consensus(args.n_workers)
    print(fa)
    return 0


def _map(args) -> int:
    from .config import AsmConfig
    from .io.seqdb import SeqDB
    from .ops.index import build_index
    from .ops.kernels import require_device
    from .ops.mapping import map_reads_to_ref

    device = require_device(args.device)
    cfg = AsmConfig(k=args.k, w=args.w, r=args.r, levels=args.levels)
    ref_db = SeqDB.open(args.ref_prefix)
    read_db = SeqDB.open(args.read_prefix)
    ref_idx = build_index(ref_db, cfg, device)
    read_idx = build_index(read_db, cfg, device)
    rows = map_reads_to_ref(read_idx, read_db.lengths, ref_idx, cfg)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for r in rows:
            print(" ".join(str(int(v)) for v in r), file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _seqdb(args) -> int:
    from .io.seqdb import SeqDB
    # streamed: peak RSS stays bounded regardless of dataset size
    SeqDB.build_to_disk(args.reads_lst, args.prefix)
    return 0


def _dump_index(args) -> int:
    from .io import formats
    x, y = formats.read_mmlist(args.mmlist)
    n = args.limit or len(x)
    for i in range(min(n, len(x))):
        xi, yi = int(x[i]), int(y[i])
        print(f"{xi >> 8} {xi & 0xFF} {yi >> 32} "
              f"{(yi & 0xFFFFFFFF) >> 1} {yi & 1}")
    return 0


def _stats(args) -> int:
    import glob

    import numpy as np

    from .io import formats
    from .io.seqdb import SeqDB

    if args.prefix:
        prefix, mms, ovl = args.workdir, [], None
    else:
        prefix = os.path.join(args.workdir, "0-seqdb", "seq_dataset")
        mms = sorted(glob.glob(
            os.path.join(args.workdir, "1-index", "*-L?-*-of-*.dat")))
        mms = [p for p in mms if "-MC-" not in p]
        ovl = os.path.join(args.workdir, "2-ovlp", "preads.ovl")
    db = SeqDB.open(prefix)
    lens = np.sort(db.lengths)[::-1]
    half = lens.sum() / 2
    n50 = int(lens[np.searchsorted(np.cumsum(lens), half)])
    print(f"seqdb: {len(db)} reads, {int(lens.sum())} bases, "
          f"mean {lens.mean():.0f}, N50 {n50}, max {int(lens[0])}")
    for mm in mms:
        x, y = formats.read_mmlist(mm)
        if not len(x):
            continue
        dens = 1000.0 * len(x) / lens.sum()
        h, c = np.unique(x >> np.uint64(8), return_counts=True)
        hist = np.bincount(np.minimum(c, 10))
        print(f"{os.path.basename(mm)}: {len(x)} SHIMMERs "
              f"({dens:.2f}/kb), {len(h)} distinct; multiplicity "
              "histogram (1..9,10+): "
              + " ".join(str(int(v)) for v in hist[1:]))
    if ovl and os.path.exists(ovl):
        rid0 = []
        with open(ovl, "rb") as f:
            for ln in f:
                if ln.startswith(b"-"):
                    break
                rid0.append(int(ln.split(b" ", 1)[0]))
        deg = np.bincount(np.asarray(rid0, np.int64), minlength=len(db))
        print(f"overlaps: {len(rid0)} records; per-read out-degree "
              f"mean {deg.mean():.1f}, median {int(np.median(deg))}, "
              f"zero-degree reads {(deg == 0).sum()}")
    return 0


def _gather_mc(args) -> int:
    # merge per-chunk minimizer-count files into one, summing counts per
    # mer (reference shmr_gather_mc, src/shmr_gather_mc.c:61-82 /
    # aggregate_mm_count, src/shmr_utils.c:162-176)
    import numpy as np

    from .io import formats
    mers, counts = [], []
    for p in args.mc_files:
        m, c = formats.read_mm_count(p)
        mers.append(m)
        counts.append(c)
    m = np.concatenate(mers) if mers else np.zeros(0, np.uint64)
    c = np.concatenate(counts) if counts else np.zeros(0, np.uint32)
    um, inv = np.unique(m, return_inverse=True)
    uc = np.zeros(len(um), np.uint64)
    np.add.at(uc, inv, c.astype(np.uint64))
    formats.write_mm_count(args.output, um, uc.astype(np.uint32))
    print(f"{len(um)} mers from {len(args.mc_files)} chunk files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
