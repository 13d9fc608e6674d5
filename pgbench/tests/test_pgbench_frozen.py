"""The reads of the benchmark's configurations are frozen: the read files,
the warm-up file and the layout of each configuration, for one seed at
full size and two with fewer reads a file, hash to what they hashed to
before genome models of several sequences came in.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PGB = os.path.dirname(HERE)
sys.path.insert(0, PGB)

import gen  # noqa: E402

FROZEN = [
    ("ecoli_k12", 3141592653, None,
     "3c30008b6923efddb79cf7e95833343c59c9b11a49b2c4a251e4581818a1e516"),
    ("ecoli_k12", 7, 40,
     "13208fa6d4568c30d852ff2534bcb9227911555510eee50a8451fbce2154ec55"),
    ("ecoli_k12", 2**33 + 5, 40,
     "69658ea8ff4556349ff84e2bcb172f7a7bc1e2b0b2741cf87ae2829dce44b82a"),
    ("chm13_r3", 3141592653, None,
     "9ee7e7f657aeba8e67d384fbe3fe37322fcf1d19c1ee2b35d0e859cf45476277"),
    ("chm13_r3", 7, 30,
     "fb347e6f5929585878255fec569fa710fe0a1c9983c531d4a793a47b53292c5b"),
    ("chm13_r3", 2**33 + 5, 30,
     "da00868999253d77e3ee710fccd3c3c30d33277dfaa419c6bd0333b2fb4eb259"),
]


def warm_span(config: str) -> int:
    cells = [json.load(open(os.path.join(PGB, "cells", f)))
             for f in sorted(os.listdir(os.path.join(PGB, "cells")))]
    spans = {int(c["warm_span"]) for c in cells if c["config"] == config}
    assert len(spans) == 1
    return spans.pop()


@pytest.mark.parametrize("config,seed,reads_per_file,want", FROZEN)
def test_reads_are_frozen(tmp_path, config, seed, reads_per_file, want):
    cfg = json.load(open(os.path.join(PGB, "configs", config + ".json")))
    if reads_per_file:
        cfg["reads"]["reads_per_file"] = reads_per_file
    g = gen.genome(seed, cfg)
    manifest, warm, _, _, layout = gen.write_reads(
        seed, cfg, g, str(tmp_path), warm_span(config))
    h = hashlib.sha256()
    for lst in (manifest, warm):
        for p in [line.strip() for line in open(lst)]:
            h.update(os.path.basename(p).encode())
            h.update(open(p, "rb").read())
    h.update(np.ascontiguousarray(layout[:, :3], "<i8").tobytes())
    assert h.hexdigest() == want
    # one sequence: every read's sequence index is 0
    assert len(g.seqs) == 1 and not layout[:, 3].any()
