"""Device-trace arithmetic: what ran on the device, and when it was idle.

Reads a torch.profiler Chrome trace.  Device intervals are its kernel,
copy and memset events; harness spans are the `pgbench:<stage>` user
annotations that run.py wraps around each stage call.  The union of
intervals is the arithmetic of chip_smoke.py's busy_ms, rewritten here so
that the yardstick does not move with the program.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pgbench:"


def load(path: str):
    """(device events, spans): device events as (start, end, name, cat) in
    microseconds, spans as (start, end, stage), both sorted by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            ts = float(e["ts"])
            dev.append((ts, ts + float(e.get("dur", 0)), e.get("name", ""), cat))
        elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            ts = float(e["ts"])
            spans.append((ts, ts + float(e.get("dur", 0)),
                          e["name"][len(SPAN_PREFIX):]))
    dev.sort()
    spans.sort()
    return dev, spans


def union(intervals, lo: float = float("-inf"), hi: float = float("inf")):
    """Merged [start, end) intervals, clipped to [lo, hi)."""
    out = []
    for a, b, *_ in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def busy(intervals, lo: float = float("-inf"), hi: float = float("inf")):
    """Length of the union of the intervals within [lo, hi)."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def span_at(spans, t: float) -> str:
    """The stage whose span holds time t, or "between" outside them all."""
    for a, b, name in spans:
        if a <= t < b:
            return name
        if a > t:
            break
    return "between"


def idle_gaps(dev, spans, lo: float, hi: float, n: int = 10):
    """The n longest device-idle gaps within [lo, hi), each named by the
    stage the host was in at its middle: [[stage, seconds], ...]."""
    merged = union(dev, lo, hi)
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((a - t, t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((hi - t, t, hi))
    gaps.sort(reverse=True)
    return [[span_at(spans, (a + b) / 2), g / 1e6] for g, a, b in gaps[:n]]


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[5:] if name.startswith("void ") else name


def top_ops(dev, lo: float, hi: float, n: int = 10):
    """The n device operations with most summed time within [lo, hi),
    by short name: [[name, seconds], ...]."""
    tot: dict = {}
    for a, b, name, _ in dev:
        name = short_name(name)
        a, b = max(a, lo), min(b, hi)
        if b > a:
            tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k, v / 1e6] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def within_spans(dev, spans, stage: str):
    """Kernels that start inside a span of `stage`."""
    win = [(a, b) for a, b, name in spans if name == stage]
    out = []
    for ev in dev:
        if ev[3] == "kernel" and any(a <= ev[0] < b for a, b in win):
            out.append(ev)
    return out
