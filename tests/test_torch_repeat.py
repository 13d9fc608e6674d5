"""The string graph's hard paths through the port, held to the JAX package.

A 150 kb repeat-stressed genome (tests/simdata.repeat_genome: dispersed
elements, a tandem array and ~99%-identical segmental duplications) at
16x of 4 kb reads drives layout through bundles, compound paths and
alternate contigs, which uniform-random genomes never reach.  Both
packages' Assembly (with_alt, the alt polish gate lowered to 0) run in
one process: every file of stages 1-4 and of the alt polish is
byte-identical.

The member order of a compound path's bundle edges follows Python's
string hash seed in both packages (graph/layout.py joins a set of edge
names), so comparisons across processes sort the members; the
subprocess test pins that nothing else varies with the seed.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import torch

from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.pipeline.run import Assembly as JaxAssembly
from peregrine_tpu_torch import simdata
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.pipeline.run import Assembly
from tests import simdata as jax_simdata

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(k=12, w=24, r=4, levels=2, min_len=2500, sketch_pad_len=8192,
           sketch_batch=16, alt_cns_min_size=0)
N, SEGDUP = 150_000, (25_000, 37_500)
STAGES = ("1-index", "2-ovlp", "3-asm", "4-cns", "4-cns-alt")
HARD = ("3-asm/c_path", "3-asm/a_ctg_tiling_path", "3-asm/a_ctg.fa",
        "4-cns-alt/a_ctg_cns.fa")

# one port run in a fresh process: argv = outdir; the repeat genome's reads
# as above, then run_draft and build_consensus on the CPU
_RUN = """
import sys
import numpy as np
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.pipeline.run import Assembly
from peregrine_tpu_torch.simdata import repeat_genome, simulate_reads
rng = np.random.default_rng(9)
chroms, _ = repeat_genome(rng, %(n)d, n_chrom=1, segdup_len=%(segdup)r)
reads, _ = simulate_reads(rng, chroms[0], read_len=4000, coverage=16.0,
                          circular_wrap=8000)
asm = Assembly(sys.argv[1], AsmConfig(**%(cfg)r), device="cpu",
               with_alt=True)
asm.run_draft(reads=reads)
asm.build_consensus()
"""




def _files(root):
    out = set()
    for stage in STAGES:
        for d, _, names in os.walk(os.path.join(root, stage)):
            out |= {os.path.relpath(os.path.join(d, n), root) for n in names}
    return out


def test_repeat_genome_copy_matches_tests_simdata():
    for kw in (dict(n_chrom=1, segdup_len=SEGDUP),
               dict(n_chrom=2, segdup_len=(5_000, 9_000), hap_div=0.01)):
        got = simdata.repeat_genome(np.random.default_rng(9), 120_000, **kw)
        want = jax_simdata.repeat_genome(np.random.default_rng(9), 120_000,
                                         **kw)
        assert got == want
        assert got[1]["segdup"] and got[1]["tandem"]


def test_repeat_genome_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    chroms, info = simdata.repeat_genome(rng, N, n_chrom=1,
                                         segdup_len=SEGDUP)
    assert info["segdup"]
    reads, _ = simdata.simulate_reads(rng, chroms[0], read_len=4000,
                                      coverage=16.0, circular_wrap=8000)
    for name, asm in (
            ("jax", JaxAssembly(str(tmp_path / "jax"), JaxConfig(**CFG),
                                with_alt=True)),
            ("torch", Assembly(str(tmp_path / "torch"), AsmConfig(**CFG),
                               device="cpu", with_alt=True))):
        asm.run_draft(reads=reads)
        asm.build_consensus()
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "torch")
    files = _files(out)
    assert files == _files(jax_out)
    assert set(HARD) <= files
    for f in sorted(files):
        assert filecmp.cmp(os.path.join(jax_out, f), os.path.join(out, f),
                           shallow=False), f
    for f in HARD:
        assert os.path.getsize(os.path.join(out, f)) > 0, f


def _sorted_members(path):
    """c_path with each compound row's '|'-joined bundle edges sorted."""
    rows = []
    with open(path) as f:
        for ln in f:
            rows.append(" ".join("|".join(sorted(tok.split("|")))
                                 for tok in ln.split()))
    return rows


def test_only_compound_member_order_follows_the_hash_seed(tmp_path):
    """The port at two PYTHONHASHSEED values: p_ctg.fa, a_ctg.fa and
    ctg_paths are equal, and c_path is equal with its members sorted."""
    src = _RUN % dict(n=N, segdup=SEGDUP, cfg=CFG)
    outs = []
    for seed in ("1", "2"):
        out = str(tmp_path / f"seed{seed}")
        env = dict(os.environ, PYTHONHASHSEED=seed, OMP_NUM_THREADS="2")
        subprocess.run([sys.executable, "-c", src, out], cwd=ROOT, env=env,
                       check=True, timeout=300)
        outs.append(out)
    a, b = outs
    for f in ("3-asm/p_ctg.fa", "3-asm/a_ctg.fa", "3-asm/ctg_paths"):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    ca, cb = (_sorted_members(os.path.join(d, "3-asm/c_path"))
              for d in outs)
    assert ca and ca == cb
