"""The port's multi-process paths: two gloo ranks on the CPU.

Each rank is a subprocess (tests/torch_multihost_worker.py) that joins
the group through a file:// address under tmp_path, with a timeout on
init_process_group and on the subprocess.  On the set of
scripts/multihost_pipeline.py (60 kb genome, 4 kb reads, 14x, k=12,
w=24, r=4, consensus windows of 6 kb), Assembly.run_multihost with
consensus on two ranks writes every stage file byte-identical to the JAX
package's single-process run of the same configuration on its 8-device
CPU mesh, and each rank does at least 0.8 of its fair share of the round
alignments and of the consensus windows.  The sharded functions over a
two-rank group give what the in-process mesh gives, shard by shard.
`asm --multihost` without a torchrun environment runs as one process.
"""

import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.pipeline.run import Assembly as JaxAssembly
from peregrine_tpu_torch import cli
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops.index import build_index
from peregrine_tpu_torch.parallel import distributed
from peregrine_tpu_torch.parallel.mesh import make_mesh
from peregrine_tpu_torch.parallel.sharded_index import sharded_index_host
from peregrine_tpu_torch.parallel.sharded_overlap import (shard_seqdb,
                                                         sharded_align)
from peregrine_tpu_torch.parallel.sharded_pairs import build_pairs_mesh
from peregrine_tpu_torch.pipeline.run import Assembly
from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                         write_reads)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_multihost_worker import PIPELINE_CFG  # noqa: E402

STAGE_FILES = ("1-index/shmr-L2-01-of-01.dat",
               "1-index/shmr-L2-MC-01-of-01.dat", "2-ovlp/preads.ovl",
               "3-asm/sg_edges_list", "3-asm/utg_data", "3-asm/ctg_paths",
               "3-asm/p_ctg_tiling_path", "3-asm/p_ctg.fa",
               "4-cns/p_ctg_cns.fa")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")


def _ranks(mode: str, world: int, out: str) -> list:
    """Run `world` gloo ranks of the worker; returns their outputs."""
    init = "file://" + os.path.join(out, f"init-{mode}")
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), init, out, "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def reads_set(tmp_path_factory):
    """scripts/multihost_pipeline.py's reads, and the JAX package's
    single-process run on them (run_draft, then build_consensus, on the
    8-device CPU mesh)."""
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 60000)
    reads, _ = simulate_reads(rng, genome, read_len=4000, coverage=14.0,
                              error=0.005, circular_wrap=6000)
    lst = str(d / "reads.lst")
    write_reads(reads, str(d / "reads.fa"), lst)
    cfg = JaxConfig(**{f: getattr(PIPELINE_CFG, f)
                       for f in PIPELINE_CFG.__dataclass_fields__})
    asm = JaxAssembly(str(d / "jax"), cfg)
    asm.run_draft(reads_list=lst)
    asm.build_consensus()
    return d, lst


def _same_files(a: str, b: str) -> None:
    for rel in STAGE_FILES:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), f"{rel} differs"


def test_two_ranks_match_jax_single_process(reads_set):
    d, lst = reads_set
    out = str(d / "two")
    os.makedirs(out)
    os.symlink(lst, os.path.join(out, "reads.lst"))
    outs = _ranks("pipeline", 2, out)
    _same_files(str(d / "jax"), os.path.join(out, "wd"))
    # the work split: each rank >= 0.8 of its fair share (1/2) of the
    # round alignments and of the consensus windows
    for r, o in enumerate(outs):
        m = re.search(r"rank share: (\d+) of (\d+) round alignments", o)
        w = re.search(r"rank \d+ computed (\d+) of (\d+) windows", o)
        assert m and w, f"rank {r} printed no share:\n{o[-2000:]}"
        for done, total in (m.groups(), w.groups()):
            assert int(total) > 0
            assert int(done) / int(total) >= 0.8 / 2, (r, done, total)


def test_cli_multihost_without_torchrun_is_one_process(reads_set, tmp_path,
                                                        monkeypatch, capsys):
    """Without torchrun's environment `asm --multihost` runs at world
    size 1 and writes what the single-device run writes."""
    d, lst = reads_set
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    flags = ["--device", "cpu", "--with-consensus", "--shimmer-k", "12",
             "--shimmer-w", "24", "--shimmer-r", "4", "--min_len", "2500"]
    fas = []
    for name, extra in (("single", []), ("multihost", ["--multihost"])):
        out = str(tmp_path / name)
        assert cli.main(["asm", lst, "--output", out] + flags + extra) == 0
        fas.append(capsys.readouterr().out.strip())
    assert fas[1] == str(tmp_path / "multihost" / "4-cns" / "p_ctg_cns.fa")
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    _same_files(str(tmp_path / "single"), str(tmp_path / "multihost"))


def test_no_group_is_rank_0_of_1(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() == 0
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.is_primary()
    distributed.barrier("nothing to wait for")
    assert distributed.global_mesh("cpu").n == 1
    assert distributed.local_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("k", [12, 28])
def test_group_mesh_equals_in_process_mesh(tmp_path, k):
    """sharded_index_host, build_pairs_mesh and sharded_align over a
    two-rank gloo group (Mesh.from_group: all_gather of the counts, then
    all_to_all_single and all_gather with equal splits) equal the
    in-process two-shard mesh's results, shard by shard."""
    rng = np.random.default_rng(k)
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=2000, coverage=8.0)
    db = SeqDB.from_reads(reads)
    idx = build_index(db, AsmConfig(k=k, w=24, r=4, levels=2,
                                    sketch_pad_len=4096, sketch_batch=16),
                      "cpu")
    codes, lens = db.padded_code_batch(range(len(db)), 4096)
    nreq, L = 24, 4096
    q = rng.integers(0, len(db), nreq)
    t = rng.integers(0, len(db), nreq)
    shift = rng.integers(0, 200, nreq)
    requests = np.stack([
        q, db.offsets[q] + shift, db.lengths[q] - shift,
        rng.integers(0, 2, nreq), t, db.offsets[t], db.lengths[t],
        rng.integers(0, 2, nreq)], 1).astype(np.int64)
    np.savez(tmp_path / "data.npz", codes=codes, lens=lens,
             rids=np.arange(len(db), dtype=np.int64), k=k, ix=idx.x,
             iy=idx.y, mh=idx.mc_hash, mc=idx.mc_count, rlen=db.lengths,
             data=db.data, offsets=db.offsets, requests=requests, L=L)
    _ranks("collectives", 2, str(tmp_path))

    mesh = make_mesh("cpu", 2)
    want = {}
    for i, (x, y) in enumerate(sharded_index_host(
            mesh, codes, lens, np.arange(len(db)), w=24, k=k, r=4,
            levels=2)):
        want[f"x{i}"], want[f"y{i}"] = x, y
    pairs, stream = build_pairs_mesh(idx, db.lengths, mesh)
    for i, a in enumerate(pairs + stream):
        want[f"p{i}"] = a
    r = requests
    want["align"] = np.stack(sharded_align(
        shard_seqdb(db.data, db.offsets, db.lengths, mesh), r[:, 0], r[:, 1],
        r[:, 2], r[:, 3], r[:, 4], r[:, 5], r[:, 6], r[:, 7], L=L), 1)
    assert len(want["p0"]) > 0
    for rank in (0, 1):
        got = np.load(tmp_path / f"got-{rank}.npz")
        assert sorted(got.files) == sorted(want)
        for key, a in want.items():
            assert got[key].dtype == a.dtype, key
            np.testing.assert_array_equal(got[key], a, err_msg=key)


def test_a_rank_never_reads_a_peers_half_written_config(tmp_path,
                                                        monkeypatch):
    """The ranks of a run construct their Assembly over one output
    directory at once.  While a peer is still writing config.json, a rank
    finds no file or a whole one, never a partial one that it would
    refuse as a config mismatch."""
    out = str(tmp_path / "wd")
    writing, go = threading.Event(), threading.Event()
    to_json = AsmConfig.to_json

    def held_to_json(self):
        if threading.current_thread().name == "peer":
            writing.set()
            assert go.wait(60)
        return to_json(self)

    monkeypatch.setattr(AsmConfig, "to_json", held_to_json)
    errors = []

    def peer():
        try:
            Assembly(out, PIPELINE_CFG, device="cpu")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=peer, name="peer")
    th.start()
    try:
        assert writing.wait(60)
        Assembly(out, PIPELINE_CFG, device="cpu")
    finally:
        go.set()
        th.join()
    assert not errors, errors
    with open(os.path.join(out, "config.json")) as f:
        assert AsmConfig.from_json(f.read()) == PIPELINE_CFG
    assert sorted(os.listdir(out)) == ["0-seqdb", "1-index", "2-ovlp",
                                       "3-asm", "4-cns", "config.json"]
