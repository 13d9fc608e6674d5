#!/usr/bin/env python3
"""The wide sketch's two kernels of one checkout on one CUDA card, timed
across the window w: wide_emit at w = 5, 80 and 255, and the stream
(wide_stream, and for a checkout whose wide_stream leaves the stream
uncompacted, wide_stream followed by its compact_planes).

    python3 scripts/torch_wide_kernels_w.py [--tree DIR]

--tree names the checkout whose peregrine_tpu_torch is imported (default:
the one holding this script); the inputs come from this script, seeded,
so every tree gets the same ones.  To compare two commits in one call on
one card, unpack the other into a directory that .gitignore lists
(`wd-*/`) and run the script once per tree, in the order parent, change,
change, parent.

Inputs: 64 reads of random codes with 0.1% ambiguous bases and lengths of
0.8-1.0 L at L = 16,384 (stage 1's main read bucket) and 40,960 (stage
4's contig batches), k = 28.  Each kernel is timed as chip_smoke.py times
phase 3's (chip_smoke.kernel_ms: 50 launches back to back) and checked
against this checkout's plain version; its byte bound is each input byte
read once and each output byte written once at 3.35 TB/s.  Prints one
JSON line with the times, the bounds, the card's name and its power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K, WS = 64, 28, (5, 80, 255)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to import the port from")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_kernels_w: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from peregrine_tpu_torch.ops import kernels as kn
    if not kn.__file__.startswith(os.path.join(tree, "")):
        raise SystemExit(f"imported {kn.__file__}, not from {tree}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.smi("name,power.limit")
    cs.say(f"tree {tree}: {card}")
    kn.library()

    def us(nbytes):
        return nbytes / cs.HBM_BYTES_PER_S * 1e6

    rng = np.random.default_rng(16)
    out = {"tree": tree, "card": card, "shapes": []}
    for L in (16384, 40960):
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random((B, L)) < 0.001] = 4
        lens = rng.integers(int(0.8 * L), L + 1, B).astype(np.int32)
        c, ln, rd = (torch.from_numpy(a).cuda() for a in
                     (codes, lens, np.arange(B, dtype=np.int64)))
        x, y, li, keep = kn.wide_stream_plain(c, ln, rd, K)
        (sx, sy, sl), n = kn.compact_planes_plain(keep, (x, y, li),
                                                  (-1, -1, 0))
        kept = int(n.sum())
        got = kn.wide_stream(c, ln, rd, k=K)
        shape = {"L": L, "kept": kept}
        if got[3].dim() == 1:  # the compacted stream and its counts
            ok = all(bool((a == b).all()) for a, b in
                     [(got[3], n)] + [p for a, b in zip(got, (sx, sy, sl))
                                      for p in cs.prefix_pairs(a, b, n)])
            shape["stream_us"] = cs.kernel_ms(
                lambda: kn.wide_stream(c, ln, rd, k=K)) * 1e3
        else:  # the stream at every column, then its compaction
            ok = all(torch.equal(a, b)
                     for a, b in zip(got, (x, y, li, keep)))

            def pair():
                s = kn.wide_stream(c, ln, rd, k=K)
                kn.compact_planes(s[3], s[:3], (-1, -1, 0))
            shape["stream_us"] = cs.kernel_ms(pair) * 1e3
        shape["stream_bound_us"] = us(B * L + 20 * kept + 16 * B)
        shape["stream_equal"] = ok
        for w in WS:
            want = kn.wide_emit_plain(sx, sl, n, w, K)
            emit_ok = torch.equal(kn.wide_emit(sx, sl, n, w=w, k=K), want)
            shape[f"emit_w{w}_us"] = cs.kernel_ms(
                lambda: kn.wide_emit(sx, sl, n, w=w, k=K)) * 1e3
            shape[f"emit_w{w}_equal"] = emit_ok
        shape["emit_bound_us"] = us(12 * kept + B * L + 4 * B)
        out["shapes"].append(shape)
        cs.say(f"L={L}: " + ", ".join(
            f"{key} {val:.3f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in shape.items()))
    print(json.dumps({"wide_kernels_w": out}), flush=True)
    bad = [s for s in out["shapes"] for key, v in s.items()
           if key.endswith("equal") and not v]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
