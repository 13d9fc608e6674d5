"""Faults planted in the program's timed path, each of which the check has
to see as not correct.  The CPU tests plant them in whole runs, and
calibrate.py reads them on the card at a cell's own size.

* stage1_half     half of the batch left out: stage 1 indexes every other
                  read;
* stage2_none     stage 2 returns its state unchanged: no overlaps;
* stage2_half     half of the batch left out: stage 2's overlaps of every
                  other query read dropped, as where half its chunks or
                  half the pair map's pairs go missing;
* stage2_altered  an answer altered where it is produced: each overlap
                  names the next read as its second.

Stage 2 is patched at ops.overlap.overlap_all_spec, which every cell's
route reaches (the host path through overlap_all with more than one
worker, the device path directly).
"""

from __future__ import annotations

import contextlib

import numpy as np

NAMES = ("stage1_half", "stage2_none", "stage2_half", "stage2_altered")


def _stage1_half(real):
    def step(db, cfg, device, **k):
        return real(db, cfg, device, rid_filter=np.arange(0, len(db), 2), **k)
    return step


def _stage2(keep):
    def wrap(real):
        def step(db, *a, **k):
            return keep(real(db, *a, **k), len(db))
        return step
    return wrap


def _none(o, n):
    return o[:0]


def _half(o, n):
    return o[(o["y0"] >> np.uint64(32)) % np.uint64(2) == 0]


def _altered(o, n):
    o = o.copy()
    rid = o["y1"] >> np.uint64(32)
    o["y1"] = (o["y1"] & np.uint64(0xFFFFFFFF)) | (
        ((rid + np.uint64(1)) % np.uint64(n)) << np.uint64(32))
    return o


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault `name` in place, until the block ends."""
    import peregrine_tpu_torch.ops.overlap as ov
    import peregrine_tpu_torch.pipeline.run as pr
    mod, attr, wrap = {
        "stage1_half": (pr, "build_index", _stage1_half),
        "stage2_none": (ov, "overlap_all_spec", _stage2(_none)),
        "stage2_half": (ov, "overlap_all_spec", _stage2(_half)),
        "stage2_altered": (ov, "overlap_all_spec", _stage2(_altered)),
    }[name]
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
