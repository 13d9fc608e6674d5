#!/usr/bin/env python3
"""Host-to-card copy rates by piece size, and the seqdb upload's split,
on one CUDA card.

    python3 scripts/torch_upload_pieces.py [--bases 139609187]

1. A pinned host buffer copied to the card with non_blocking copies, at
   piece sizes from 256 KiB to 64 MiB (the same bytes each time, one
   piece after another on one stream, CUDA events around them), and a
   pageable buffer at a few of the sizes: GB/s by size.  The uploader's
   piece size (SeqDBUploader.PIECE_FW_BYTES) is the size past which the
   pinned rate no longer rises.
2. A seqdb of --bases random ACGT codes (seed 42; the default is
   chip_smoke.py's E. coli-class read set) through upload_seqdb three
   times, and through SeqDBUploader at several piece sizes, fed in
   build_to_disk's chunks of 1 << 22 bases: each wall with the
   uploader's split (pack, staging copy, waits on the buffers' events,
   allocation, bytes copied and elided) and each one's planes held to the
   first's with torch.equal.  Then the one-shot route that upload_seqdb
   replaced (pack all, pad, one pageable copy a plane), for comparison.

Prints one line per measurement and a JSON line with all of them and the
card's name and power limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bases", type=int, default=139_609_187)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_upload_pieces: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from peregrine_tpu_torch.ops import dbgather as dg

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    out: dict = {"card": card, "h2d": {}, "upload": {}}

    # 1. copy rates by piece size
    total = 64 << 20
    dst = torch.empty(total, dtype=torch.uint8, device=dev)
    for pinned in (True, False):
        src = torch.randint(0, 255, (total,), dtype=torch.uint8)
        if pinned:
            src = src.pin_memory()
        sizes = ([1 << s for s in range(18, 27)] if pinned
                 else [1 << 20, 8 << 20, 64 << 20])
        for size in sizes:
            for rep in range(2):  # the first pass warms up
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                t = time.perf_counter()
                a.record()
                for off in range(0, total, size):
                    dst[off:off + size].copy_(src[off:off + size],
                                              non_blocking=True)
                b.record()
                b.synchronize()
                host = time.perf_counter() - t
            ms = a.elapsed_time(b)
            key = f"{'pinned' if pinned else 'pageable'} {size >> 10} KiB"
            out["h2d"][key] = {"device_ms": ms, "host_ms": host * 1e3,
                               "gb_s": total / ms / 1e6}
            print(f"h2d {key}: {total >> 20} MiB in {ms:.3f} ms "
                  f"({total / ms / 1e6:.2f} GB/s; host {host * 1e3:.3f} ms)")
    del dst

    # 2. the seqdb upload
    rng = np.random.default_rng(42)
    data = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=args.bases)

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        planes = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = dict(dg.LAST_STATS)
        out["upload"].setdefault(label, []).append({"wall_s": wall, **st})
        print(f"upload {label}: {wall:.4f} s; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()))
        return planes

    first = timed("upload_seqdb", lambda: dg.upload_seqdb(data, dev))
    for _ in range(2):
        got = timed("upload_seqdb", lambda: dg.upload_seqdb(data, dev))
        assert torch.equal(got.fw, first.fw) and torch.equal(got.amb,
                                                             first.amb)
    assert not first.amb.any()

    def fed(piece):
        dg.SeqDBUploader.PIECE_FW_BYTES = piece
        up = dg.SeqDBUploader(dev, est_bases=len(data))
        for i in range(0, len(data), 1 << 22):
            up.feed(data[i:i + (1 << 22)])
        return up.finish()

    default = dg.SeqDBUploader.PIECE_FW_BYTES
    for piece in (1 << 20, 2 << 20, 4 << 20, 8 << 20, 16 << 20, 32 << 20):
        got = timed(f"uploader piece {piece >> 20} MiB", lambda: fed(piece))
        assert torch.equal(got.fw, first.fw) and torch.equal(got.amb,
                                                             first.amb)
    dg.SeqDBUploader.PIECE_FW_BYTES = default

    def one_shot():
        dg.LAST_STATS.clear()
        t = time.perf_counter()
        fw, amb = dg.pack_db_np(data)
        t1 = time.perf_counter()
        planes = dg.packed_from_numpy(dg._pad_rows(fw, 1 << 19),
                                      dg._pad_rows(amb, 1 << 17), dev)
        torch.cuda.synchronize()
        dg.LAST_STATS.update(pack_s=t1 - t,
                             pad_and_copy_s=time.perf_counter() - t1)
        return planes

    for _ in range(2):
        got = timed("one-shot pack + pageable copy", one_shot)
        assert torch.equal(got.fw, first.fw) and torch.equal(got.amb,
                                                             first.amb)
    print(json.dumps({"upload_pieces": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
