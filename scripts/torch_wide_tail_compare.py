#!/usr/bin/env python3
"""The wide (k > 16) stage-1 tail of one checkout on one CUDA card: the
reduction levels after the sketch and the drains, timed as that
checkout's batch step runs them.

    python3 scripts/torch_wide_tail_compare.py [--tree DIR]

--tree names the checkout whose peregrine_tpu_torch is imported (default:
the one holding this script); the inputs come from this script, seeded,
so every tree gets the same ones.  To compare two commits in one call on
one card, unpack the other into a directory that .gitignore lists
(`wd-*/`) and run the script once per tree, in the order parent, change,
change, parent.

Inputs: the wide sketch (k=28, w=80) of 64 reads of random codes with
0.1% ambiguous bases and lengths of 0.8-1.0 L at L = 16,384 (stage 1's
main read bucket, ~400 minimizers a read), made with the checkout's
plain versions.  Timed (chip_smoke.kernel_ms: 50 calls back to back, the
device time per call), each output checked against the checkout's plain
versions:
  - drain_records of the sketch, the level-0 stream of --with-L0-index
    (int64 records, width L), and of the k=16 sketch's (H, P) planes;
  - reduce_wide alone on the sketch cut to the cap of 2,048 columns
    (contiguous copies), and level 1 as the step runs it
    (index.reduce_levels with the cap: the parent copies the capped
    planes and clamps the counts before reduce_wide, a checkout with
    reduce_wide_drain reads the planes in place);
  - the final level (level 2) and its drain as the step runs them, capped
    (width out_cap = 227) and uncapped (width L): reduce_wide followed by
    drain_records, or reduce_wide_drain where the checkout has it.
Each has its byte bound (each input byte read once, each output byte
written once, at 3.35 TB/s).  Prints one JSON line with the times, the
bounds, the card's name and its power limit.  Exits non-zero without a
CUDA device or where a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, K, W, R, CAP = 64, 16384, 28, 80, 6, 2048
OUT_CAP = max(64, CAP // int((R / 2) ** 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to import the port from")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_tail_compare: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from peregrine_tpu_torch.ops import index, kernels as kn
    if not kn.__file__.startswith(os.path.join(tree, "")):
        raise SystemExit(f"imported {kn.__file__}, not from {tree}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.smi("name,power.limit")
    cs.say(f"tree {tree}: {card}")
    kn.library()
    fused = hasattr(kn, "reduce_wide_drain")

    def us(nbytes):
        return nbytes / cs.HBM_BYTES_PER_S * 1e6

    def streams(n_rec, slots=4):
        return (torch.full((n_rec, 2), 7, dtype=torch.int64, device="cuda"),
                torch.full((slots, 2, B), -5, dtype=torch.int32,
                           device="cuda"),
                torch.zeros(3, dtype=torch.int64, device="cuda"))

    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.001] = 4
    lens = rng.integers(int(0.8 * L), L + 1, B).astype(np.int32)
    c, ln, rd = (torch.from_numpy(a).cuda() for a in
                 (codes, lens, np.arange(B, dtype=np.int64) * 7919))
    x0, y0, li, keep = kn.wide_stream_plain(c, ln, rd, K)
    (sx, sy, sl), ns = kn.compact_planes_plain(keep, (x0, y0, li),
                                               (-1, -1, 0))
    emit = kn.wide_emit_plain(sx, sl, ns, W, K)
    (x, y), c0 = kn.compact_planes_plain(emit, (sx, sy), (-1, -1))
    H, P, dest, n16 = kn.build_stream_plain(c, ln, 16)
    sH, sP = kn.move_plane_plain(dest, H, P)
    dest16, c16 = kn.emit_mask_plain(sH, sP, n16, W, 16)
    H16, P16 = kn.move_plane_plain(dest16, sH, sP)
    out = {"tree": tree, "card": card, "fused": fused, "B": B, "L": L,
           "records_a_row": float(c0.float().mean()), "times_us": {},
           "bound_us": {}, "equal": {}}

    def timed(name, fn, nbytes):
        out["times_us"][name] = cs.kernel_ms(fn) * 1e3
        out["bound_us"][name] = us(nbytes)

    # the level-0 drains: the records read and written once, the counts
    # (and at k=16 the rids) read
    for label, a, b, cnt, k, per in (("drain_l0_k28", x, y, c0, K, 32),
                                     ("drain_l0_k16", H16, P16, c16, 16,
                                      24)):
        n = int(cnt.clamp(0, L).sum())
        got, want = streams(n), streams(n)
        kn.drain_records(a, b, rd, cnt, cnt, got[2], got[0], None, k=k,
                         width=L)
        kn.drain_records_plain(a, b, rd, cnt, cnt, want[2], want[0], None,
                               k=k, width=L)
        out["equal"][label] = all(torch.equal(p, q)
                                  for p, q in zip(got, want))
        run = streams(320 * n)
        timed(label, lambda: kn.drain_records(
            a, b, rd, cnt, cnt, run[2], run[0], None, k=k, width=L),
            per * n + (4 if k > 16 else 12) * B)

    # level 1 on the capped sketch
    xc, yc = x[:, :CAP].contiguous(), y[:, :CAP].contiguous()
    nc = c0.clamp(max=CAP)
    l1 = kn.reduce_wide_plain(xc, yc, nc, R)
    out["equal"]["reduce_wide_capped"] = all(
        torch.equal(p, q) for p, q in zip(kn.reduce_wide(xc, yc, nc, r=R),
                                          l1))
    below = int(nc.sum())
    timed("reduce_wide_capped", lambda: kn.reduce_wide(xc, yc, nc, r=R),
          16 * below + 16 * B * CAP + 8 * B)
    got = index.reduce_levels(x, y, c0, k=K, r=R, levels=1, cap=CAP)
    out["equal"]["level1_as_the_step"] = all(
        torch.equal(p, q) for p, q in zip(got[:3], l1))
    timed("level1_as_the_step", lambda: index.reduce_levels(
        x, y, c0, k=K, r=R, levels=1, cap=CAP),
        16 * below + 16 * B * CAP + 8 * B)

    # the final level and its drain, capped and uncapped
    lu = kn.reduce_wide_plain(x, y, c0, R)
    for label, (lx, ly, lc), width in (("final_capped", l1, OUT_CAP),
                                       ("final_uncapped", lu, L)):
        l2 = kn.reduce_wide_plain(lx, ly, lc, R)
        n_rec = int(l2[2].clamp(max=width).sum())
        sketch_n = lc + 5

        def step(run):
            if fused:
                kn.reduce_wide_drain(lx, ly, lc, sketch_n, run[2], run[0],
                                     run[1], r=R, width=width)
            else:
                ox, oy, oc = kn.reduce_wide(lx, ly, lc, r=R)
                kn.drain_records(ox, oy, None, oc, sketch_n, run[2], run[0],
                                 run[1], k=K, width=width)
        got, want = streams(n_rec), streams(n_rec)
        step(got)
        kn.drain_records_plain(*l2[:2], None, l2[2], sketch_n, want[2],
                               want[0], want[1], k=K, width=width)
        out["equal"][label] = all(torch.equal(p, q)
                                  for p, q in zip(got, want))
        run = streams(320 * n_rec)
        timed(label, lambda: step(run),
              16 * int(lc.clamp(0, lx.shape[1]).sum()) + 16 * n_rec
              + 16 * B + 32)
    torch.cuda.synchronize()
    cs.say(", ".join(f"{key} {val:.3f} us (bound {out['bound_us'][key]:.3f})"
                     for key, val in out["times_us"].items()))
    cs.say(f"equal: {out['equal']}")
    print(json.dumps({"wide_tail": out}), flush=True)
    return 0 if all(out["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
