"""`asm` through both packages on the CPU: identical stage outputs.

The JAX package's CLI and the port's CLI (--device cpu) run on the same
simulated reads; the index files, preads.ovl and p_ctg.fa must be
byte-identical.  Also: resume in the port, a JAX-written output directory
resumed by the port, asm --profile-dir, and the port's refusals (a missing
CUDA device, a changed config).  The device stage-2 flags are in
tests/test_torch_overlap_device.py; --mesh, --shard-overlap and
--multihost in tests/test_torch_parallel.py and
tests/test_torch_multihost.py.  Stage 4 (--with-consensus) and the
level-0 index are in tests/test_torch_consensus.py.
"""

import filecmp
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from peregrine_tpu import cli as jax_cli
from peregrine_tpu_torch import cli
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.pipeline.run import Assembly, ConfigMismatchError
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

OUTPUTS = ("1-index/shmr-L2-01-of-01.dat", "1-index/shmr-L2-MC-01-of-01.dat",
           "2-ovlp/preads.ovl", "3-asm/p_ctg.fa", "config.json")

# (genome, read length, coverage, CLI flags)
SHAPES = {
    # tests/test_resume.py's shape
    "k12": (30_000, 3000, 10.0, ["--shimmer-k", "12", "--shimmer-w", "24",
                                 "--shimmer-r", "4", "--min_len", "2000"]),
    # the default k=16, w=80, r=6 with min_len lowered for 5 kb reads
    "default": (60_000, 5000, 12.0, ["--min_len", "2000"]),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each shape's reads and the JAX package's `asm` output on them."""
    runs = {}
    for name, (glen, rlen, cov, flags) in SHAPES.items():
        d = tmp_path_factory.mktemp(name)
        rng = np.random.default_rng(42)
        genome = random_genome(rng, glen)
        reads, _ = simulate_reads(rng, genome, read_len=rlen, coverage=cov)
        lst = str(d / "reads.lst")
        write_reads(reads, str(d / "reads.fa"), lst)
        assert jax_cli.main(["asm", lst, "--output", str(d / "jax")]
                            + flags) == 0
        runs[name] = (d, lst, flags)
    return runs


def _same(a, b, names=OUTPUTS):
    for f in names:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_asm_matches_jax(jax_runs, shape):
    d, lst, flags = jax_runs[shape]
    out = str(d / "torch")
    assert cli.main(["asm", lst, "--output", out, "--device", "cpu"]
                    + flags) == 0
    _same(str(d / "jax"), out)
    with open(os.path.join(out, "3-asm", "p_ctg.fa")) as f:
        assert f.read().count(">") >= 1


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_port_resumes_jax_checkpoints(jax_runs, shape):
    """A JAX-written 0-seqdb/1-index resumes in the port: stages 0-1 are
    loaded untouched and stages 2-3 come out identical."""
    d, lst, flags = jax_runs[shape]
    wd = str(d / "resumed")
    shutil.copytree(str(d / "jax"), wd)
    shutil.rmtree(os.path.join(wd, "2-ovlp"))
    shutil.rmtree(os.path.join(wd, "3-asm"))
    kept = [os.path.join(wd, p) for p in
            ("0-seqdb/seq_dataset.seqdb", "0-seqdb/seq_dataset.idx",
             "1-index/shmr-L2-01-of-01.dat")]
    mtimes = {p: os.path.getmtime(p) for p in kept}
    time.sleep(0.05)
    assert cli.main(["asm", lst, "--output", wd, "--device", "cpu"]
                    + flags) == 0
    _same(str(d / "jax"), wd, ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa"))
    for p in kept:
        assert os.path.getmtime(p) == mtimes[p], f"{p} was recomputed"


def _small_run(tmp_path):
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=8.0)
    cfg = AsmConfig(k=12, w=24, r=4, levels=2, min_len=2000,
                    sketch_pad_len=8192, sketch_batch=16)
    wd = str(tmp_path / "wd")
    fa = Assembly(wd, cfg, device="cpu").run_draft(reads=reads)
    return cfg, wd, fa


def test_stage_resume(tmp_path):
    cfg, wd, fa = _small_run(tmp_path)
    first = open(fa, "rb").read()
    kept = [os.path.join(wd, p) for p in
            ("0-seqdb/seq_dataset.seqdb", "1-index/shmr-L2-01-of-01.dat",
             "2-ovlp/preads.ovl")]
    mtimes = {p: os.path.getmtime(p) for p in kept}
    os.remove(fa)
    time.sleep(0.05)
    fa2 = Assembly(wd, cfg, device="cpu").run_draft()
    assert open(fa2, "rb").read() == first
    for p in kept:
        assert os.path.getmtime(p) == mtimes[p], f"{p} was recomputed"


def test_config_change_detection(tmp_path):
    cfg, wd, _ = _small_run(tmp_path)
    with pytest.raises(ConfigMismatchError):
        Assembly(wd, cfg.replace(k=14), device="cpu")
    idx_dat = os.path.join(wd, "1-index", "shmr-L2-01-of-01.dat")
    seqdb = os.path.join(wd, "0-seqdb", "seq_dataset.seqdb")
    m_idx, m_db = os.path.getmtime(idx_dat), os.path.getmtime(seqdb)
    time.sleep(0.05)
    Assembly(wd, cfg.replace(k=14), device="cpu",
             on_config_change="clean").run_draft()
    assert os.path.getmtime(seqdb) == m_db, "stage 0 was recomputed"
    assert os.path.getmtime(idx_dat) != m_idx, "stage 1 was not re-run"
    Assembly(wd, cfg.replace(k=14, sketch_batch=32), device="cpu")


def test_asm_profile_dir(jax_runs):
    """asm --profile-dir D writes a torch.profiler trace under D (host
    events on the cpu device) and the same outputs as a run without it."""
    d, lst, flags = jax_runs["k12"]
    out, prof = str(d / "profiled"), str(d / "prof")
    assert cli.main(["asm", lst, "--output", out, "--device", "cpu",
                     "--profile-dir", prof] + flags) == 0
    _same(str(d / "jax"), out)
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_missing_cuda_raises(tmp_path):
    """The default device is cuda, with no quiet switch to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["asm", "reads.lst", "--output", str(tmp_path / "wd")])
    assert not os.path.exists(tmp_path / "wd")
