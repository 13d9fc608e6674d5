"""The program's spans: where an assembly's time goes, stage by stage.

span(name) times a block on time.perf_counter() and keeps a record of it
in a bounded ring in memory (RING records, the oldest dropped first):
its id, its parent's id, its assembly's id, its name, start and end, its
thread and its attrs, counts that the block adds as it works.  The
parent is the innermost open span of the same thread; code that hands
work to pool threads passes parent= explicitly.  A span takes its
assembly's id from its parent, or from asm= (an Assembly's stage spans
pass the id new_assembly() gave it).  records() returns a snapshot of
the ring; nothing is written to disk.

While a torch.profiler records, each span also opens
record_function("pg." + name), so the spans sit in the profiler's trace
on its clock, beside the kernels (spans in threads the profiler does not
follow are left out of it).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

RING = 65536

_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()
_ids = itertools.count(1)
_assemblies = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.stack = []     # this thread's open spans, innermost last


_local = _Local()


class Span:
    """One span's record; t1 is None while it is open."""

    __slots__ = ("id", "parent", "asm", "name", "t0", "t1", "thread", "attrs")

    def __init__(self, name: str, parent: "Span | None", asm: int | None,
                 attrs: dict):
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else 0
        self.asm = (asm if asm is not None
                    else parent.asm if parent is not None else 0)
        self.name = name
        self.thread = threading.get_ident()
        self.attrs = attrs
        self.t0 = self.t1 = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def new_assembly() -> int:
    """A process-wide assembly id, for the stage spans of one Assembly."""
    return next(_assemblies)


@contextlib.contextmanager
def span(name: str, parent: Span | None = None, asm: int | None = None,
         **attrs):
    """Time the block as a span named `name`; yields its record, whose
    attrs the block may add to."""
    stack = _local.stack
    rec = Span(name, parent if parent is not None
               else stack[-1] if stack else None, asm, attrs)
    rf = None
    if _profiler._is_profiler_enabled:
        rf = torch.profiler.record_function("pg." + name)
        rf.__enter__()
    stack.append(rec)
    rec.t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec.t1 = time.perf_counter()
        stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        with _lock:
            _ring.append(rec)


def records() -> list:
    """A snapshot of the ring: the closed spans, oldest first by end."""
    with _lock:
        return list(_ring)
