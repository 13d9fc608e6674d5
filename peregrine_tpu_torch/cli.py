"""Command-line interface of the PyTorch port (the `asm` draft path).

    pg-tpu-torch asm reads.lst --output ./wd
    pg-tpu-torch asm reads.lst -k 16 -w 80 -r 6 -l 2 --min_len 4000 --device cuda

The flags and defaults are those of `pg-tpu asm`, plus --device (default
cuda; there is no quiet switch to the CPU: pass --device cpu to run
stage 1 on the host).  Flags whose paths are not yet ported exit
non-zero with a message naming the ROADMAP item; the other verbs of
pg-tpu come later.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

# flag dest -> (flag, ROADMAP item); each exits non-zero when given
_NOT_PORTED = {
    "with_consensus": ("--with-consensus", "queue 1, stage 4"),
    "with_l0": ("--with-L0-index", "queue 1, compact_planes + L0 index"),
    "device_aligner": ("--device-aligner", "queue 1, flag paths"),
    "hybrid_overlap": ("--hybrid-overlap", "queue 1, flag paths"),
    "shard_overlap": ("--shard-overlap", "queue 1, flag paths"),
    "device_pairs": ("--device-pairs", "queue 1, flag paths"),
    "mesh": ("--mesh", "queue 1, flag paths"),
    "multihost": ("--multihost", "queue 1, flag paths"),
    "profile_dir": ("--profile-dir", "queue 1, flag paths"),
}


def main(argv=None) -> int:
    from .config import DEFAULT

    p = argparse.ArgumentParser(
        prog="pg-tpu-torch",
        description="OLC assembler for accurate long reads (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    asm = sub.add_parser("asm", help="assemble reads into draft contigs")
    asm.add_argument("reads_lst", help="file listing FASTA/FASTQ(.gz) read files")
    asm.add_argument("--output", default="./wd", help="output directory")
    asm.add_argument("--device", default="cuda",
                     help="torch device for the SHIMMER index (cuda or cpu)")
    asm.add_argument("--with-consensus", action="store_true",
                     help="polish draft contigs with read consensus "
                          "(not yet ported)")
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
                     help="also write the level-0 SHIMMER index "
                          "(not yet ported)")
    asm.add_argument("--n_chunks", type=int, default=None,
                     help="overlap hash chunks (default: auto)")
    asm.add_argument("--n_workers", type=int, default=None,
                     help="overlap worker threads (default: auto)")
    for flag in ("--device-aligner", "--hybrid-overlap", "--shard-overlap",
                 "--device-pairs", "--mesh", "--multihost"):
        asm.add_argument(flag, action="store_true", help="not yet ported")
    asm.add_argument("--spill-dir", default=None,
                     help="back the overlap pair map / bucket stream with "
                          "unlinked files in this directory instead of "
                          "anonymous memory (output unchanged)")
    asm.add_argument("--mem-budget", default=None,
                     help="host anonymous-memory budget in bytes (e.g. "
                          "32e9) for the overlap stage; spill engages "
                          "automatically past it.  Default: 85%% of "
                          "MemAvailable (equals setting PG_MEM_BUDGET)")
    asm.add_argument("--profile-dir", default=None, help="not yet ported")
    asm.add_argument("--on-config-change", default="error",
                     choices=("error", "clean", "ignore"),
                     help="resuming an outdir built with a different config: "
                          "refuse (error), invalidate stages 1-4 (clean), "
                          "or trust the caller (ignore)")
    asm.add_argument("-v", "--verbose", action="store_true")

    args = p.parse_args(argv)
    for dest, (flag, item) in _NOT_PORTED.items():
        if getattr(args, dest):
            p.error(f"{flag} is not yet ported to peregrine_tpu_torch "
                    f"(ROADMAP: {item})")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(message)s")

    from .config import AsmConfig
    from .pipeline.run import Assembly

    cfg = AsmConfig(
        k=args.k, w=args.w, r=args.r, levels=args.levels,
        best_n_ovlp=args.best_n_ovlp, mc_lower=args.mc_lower,
        mc_upper=args.mc_upper, aln_bw=args.aln_bw,
        ovlp_upper=args.ovlp_upper, min_len=args.min_len,
        min_idt=args.min_idt, lfc=args.lfc,
        disable_chimer_bridge_removal=args.disable_chimer_bridge_removal,
        spill_dir=args.spill_dir)
    if args.mem_budget is not None:
        os.environ["PG_MEM_BUDGET"] = str(int(float(args.mem_budget)))
    asm_obj = Assembly(args.output, cfg, device=args.device,
                       with_alt=args.with_alt,
                       on_config_change=args.on_config_change)
    asm_obj.build_db(reads_list=args.reads_lst)
    asm_obj.build_shimmer_index()
    asm_obj.build_overlaps(args.n_chunks, args.n_workers)
    print(asm_obj.build_contigs())
    return 0


if __name__ == "__main__":
    sys.exit(main())
