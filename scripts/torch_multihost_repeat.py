"""chip_smoke.py's phase 10.5 repeated: run_multihost with the consensus
on two gloo ranks sharing cuda:0, N times for each checkout given,
against one world-size-1 run of this checkout, on the smoke's E. coli-class
set.  Every rank run gets a fresh HOME and TMPDIR.  Prints each run's
exit codes, whether its files equal world size 1's and its wall, a
failed run's last output lines, and a JSON summary.

    python3 scripts/torch_multihost_repeat.py N TREE [TREE ...]

Each TREE is the root of a checkout (this one, or a `git archive` of
another commit unpacked into a gitignored `wd-*/` directory); runs
alternate between the trees.  Needs one card.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    n, trees = int(argv[0]), argv[1:]
    for t in trees:  # each tree's libraries, built once as the smoke does
        t0 = time.time()
        subprocess.run([sys.executable, "-c",
                        "from peregrine_tpu_torch.ops import kernels, "
                        "device_align; kernels.library(); "
                        "device_align.library(); "
                        "import peregrine_tpu_torch.native"], cwd=t,
                       check=True, env=dict(os.environ, PYTHONPATH=t))
        print(f"built {t} in {time.time() - t0:.1f} s", flush=True)

    import chip_smoke as cs
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.pipeline.run import Assembly
    from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                             write_reads)

    wd = os.path.join(ROOT, "wd-repeat")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    rng = np.random.default_rng(42)
    genome = random_genome(rng, cs.GENOME)
    reads, _ = simulate_reads(rng, genome, read_len=cs.READ_LEN,
                              coverage=cs.COVERAGE, len_sd=1500, error=0.01,
                              circular_wrap=cs.WRAP)
    lst = os.path.join(wd, "reads.lst")
    write_reads(reads, os.path.join(wd, "reads.fa"), lst)
    one = os.path.join(wd, "ws1")
    t0 = time.time()
    Assembly(one, AsmConfig(mesh=True), device="cuda").run_multihost(
        lst, with_consensus=True)
    print(f"world size 1: {time.time() - t0:.1f} s", flush=True)
    rels = ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa", "4-cns/p_ctg_cns.fa")
    summary = {}
    for i in range(n):
        for t in trees:
            two = os.path.join(wd, f"{os.path.basename(t)}-{i}")
            os.makedirs(two)
            shutil.copy(lst, os.path.join(two, "reads.lst"))
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_ADDR", "MASTER_PORT")}
            env.update(PYTHONPATH=t, HOME=tempfile.mkdtemp(dir=wd),
                       TMPDIR=tempfile.mkdtemp(dir=wd))
            init = "file://" + os.path.join(two, "init")
            t0 = time.time()
            worker = os.path.join(t, "tests", "torch_multihost_worker.py")
            procs = [subprocess.Popen(
                [sys.executable, worker, "defaults", str(r), "2", init, two,
                 "cuda"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=t) for r in range(2)]
            try:
                outs = [p.communicate(timeout=300)[0] for p in procs]
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
            rcs = [p.returncode for p in procs]
            same = all(rc == 0 for rc in rcs) and all(
                open(os.path.join(one, r), "rb").read()
                == open(os.path.join(two, "wd", r), "rb").read() for r in rels)
            print(f"{os.path.basename(t)} run {i}: rcs {rcs} same {same} "
                  f"{time.time() - t0:.1f} s", flush=True)
            if not same:
                for r, o in enumerate(outs):
                    print(f"--- rank {r} ---\n"
                          + "\n".join(o.splitlines()[-40:]), flush=True)
            summary.setdefault(os.path.basename(t), []).append(same)
    print(json.dumps(summary))
    shutil.rmtree(wd, ignore_errors=True)
    return 0 if all(all(v) for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
