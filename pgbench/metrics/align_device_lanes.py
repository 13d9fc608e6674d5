"""align_device_lanes: the lanes the device aligner (pg_myers_align)
takes a window assembly, counted by the program: its overlap.align
spans' `lanes`."""

import progspans


def _lanes(recs):
    v = [r.attrs["lanes"] for r in progspans.named(recs, "overlap.align")
         if "lanes" in r.attrs]
    return sum(v) if v else None


def read(ctx):
    return progspans.mean(ctx, _lanes)
