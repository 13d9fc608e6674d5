"""align_device_ms: device milliseconds a window assembly of the banded
Myers kernels (pg_myers_align, csrc/myers_align.cu), from the trace."""


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    ms = sum(b - a for a, b, name, cat in t["dev"]
             if cat == "kernel" and "myers" in name.lower()) / 1e3
    return ms / len(ctx["runs"]) if ms > 0 else None
