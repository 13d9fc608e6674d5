"""Single source of truth for assembly parameters.

The reference spreads defaults across three layers (docopt in
py/scripts/pg_run.py:50-67, getopt defaults in each C tool, e.g.
src/shmr_overlap.c:28-42 and src/shmr_index.c:21-23).  Here every knob lives
in one frozen dataclass that all stages consume.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class AsmConfig:
    # --- SHIMMER sketch / index (src/shmr_index.c:21-23, pg_run.py defaults)
    k: int = 16            # k-mer size (<=28; 56-bit hash space)
    w: int = 80            # minimizer window (k-mers per window)
    r: int = 6             # hierarchical reduction factor per level
    levels: int = 2        # number of reduction levels (L1 or L2 index)

    # --- minimizer-count gates (src/shmr_overlap.c:28-29)
    mc_lower: int = 2      # ignore SHIMMERs seen fewer times than this
    mc_upper: int = 240    # ...or at least this many times

    # --- overlap detection (src/shmr_overlap.c:36-42)
    best_n_ovlp: int = 4         # accepted overlaps per anchor read extension
    ovlp_upper: int = 120        # skip candidate buckets larger than this
    aln_bw: int = 100            # band tolerance for overlap confirmation
    read_end_fuzz: int = 48      # max unaligned read-end slack (READ_END_FUZZINESS)
    min_ovlp_aln: int = 500      # min aligned bases to accept an overlap
    min_anchor_dist: int = 100   # min bp between paired SHIMMERs (src/shmr_utils.c:332)

    # --- string graph / layout (pg_run.py defaults, ovlp_to_graph.py args)
    min_len: int = 4000    # min overlap length for graph construction
    min_idt: float = 96.0  # min % identity for graph construction
    lfc: bool = False      # use local flow consistency repeat resolution
    disable_chimer_bridge_removal: bool = False

    # --- consensus (py/scripts/pg_asm_cns.py:154,187,240)
    cns_aln_band: int = 150      # band tolerance for read-to-template alignment
    cns_min_cov: int = 1         # min coverage for uppercase consensus base
    cns_window: int = 50000      # window growth limit (pg_asm_cns.py:77)
    cns_max_template: int = 100000  # max consensus template size
    alt_cns_min_size: int = 500000  # a_ctg.fa size gate for the alt polish
    #                                 pass (py/scripts/pg_run.py:623-624)

    # --- overlap work-distribution (no reference analog)
    dedup_overlap: bool = True   # global rid-pair dedup: speculative parallel
    #                              alignment + exact sequential replay; output
    #                              is identical to a 1-chunk run at any worker
    #                              count (the reference's per-process RPAIR
    #                              tables re-align 55-80% of pairs per added
    #                              chunk, src/shmr_overlap.c:101-107)

    # --- TPU execution knobs (no reference analog; device-side batching)
    sketch_pad_len: int = 1 << 15   # pad reads to multiples of this for sketch batches
    sketch_batch: int = 64          # reads per device sketch batch
    aln_batch: int = 1024           # alignments per device alignment batch
    aln_max_len: int = 1 << 15      # max sequence length per device alignment lane
    use_device_aligner: bool = False  # overlap confirmation on device (Myers batch)
    hybrid_overlap: bool = False    # TPU thread + host threads pull overlap
    #                                 chunks from one queue (ops.overlap
    #                                 .overlap_all_hybrid)
    mesh: bool = False              # run stage 1 (index) sharded over ALL
    #                                 devices: data-parallel sketch + hash
    #                                 all_to_all (parallel/sharded_index
    #                                 .build_index_mesh); output identical
    #                                 to the single-device build
    shard_overlap: bool = False     # shard the seqdb over all devices and
    #                                 route alignment requests via all_to_all
    #                                 (parallel/sharded_overlap.py); for
    #                                 dbs larger than one chip's HBM
    spill_dir: str | None = None    # back the pair map / bucket stream
    #                                 with unlinked files here instead of
    #                                 anonymous memory (bounded-RSS mode
    #                                 for hosts smaller than the dataset;
    #                                 reference analog: ovlp_nchunk on
    #                                 32 GB hosts, README.md:127-130).
    #                                 Output bytes are unchanged.
    device_pairs: bool = False      # build the overlap pair map on the TPU
    #                                 (ops/device_pairs.py: sorts + u32
    #                                 elementwise; byte-identical output).
    #                                 On-chip compute is ~10x the host
    #                                 build, but host<->device transfer
    #                                 dominates on remote/tunneled devices
    #                                 — enable on locally-attached TPUs
    #                                 (BENCH.md round 3)

    def replace(self, **kw) -> "AsmConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "AsmConfig":
        return cls(**json.loads(text))


DEFAULT = AsmConfig()
