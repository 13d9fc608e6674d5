"""index_roofline: the least time stage 1's work needs at the device's
peak bandwidth, as a share (%) of the time of the kernels that ran inside
the harness's stage-1 spans.

The work is counted from what the stage consumes and produces, whatever
implements it: the packed seqdb planes read once (2 bits a base and the
ambiguity plane's bit, 3/8 of a byte a base), and written once the
records of each level the stage writes (16 bytes: x and y) and a 4-byte
count a read for each such level.  Intermediates are not counted."""

import os

import devtrace
import judge


def stage1_bytes(bases: int, reads: int, records: list) -> float:
    return 3 * bases / 8 + sum(16 * n + 4 * reads for n in records)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    kern = devtrace.within_spans(t["dev"], t["spans"], "index")
    busy_us = devtrace.busy(kern)
    if busy_us <= 0:
        return None
    s = ctx["settings"]
    levels = [s["levels"]] + ([0] if ctx["cell"]["with_l0"] else [])
    d = os.path.join(ctx["outdir"], "1-index")
    records = [judge.count_records(os.path.join(d, f"shmr-L{lev}-01-of-01.dat"))
               for lev in levels]
    work = stage1_bytes(ctx["bases"], ctx["reads"], records) * len(ctx["runs"])
    return 100.0 * (work / ctx["peak_bytes_s"]) / (busy_us / 1e6)
