"""Build-on-first-use for the port's shared libraries.

Each library is compiled into peregrine_tpu_torch/build/ under a name that
carries a hash of its sources and compile command, so an edited source
rebuilds and an unchanged one is reused.  A file lock serialises
concurrent builders (several test workers import the package at once) and
the finished library is renamed into place, so no process ever loads a
half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def build_shared(name: str, sources: list[str], cmd: list[str],
                 libs: list[str] = ()) -> str:
    """Compile `sources` with `cmd -o out sources libs` unless a build of
    the same sources and command exists; returns the library path."""
    h = hashlib.sha256(" ".join(cmd + list(libs)).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            r = subprocess.run(cmd + ["-o", tmp] + sources + list(libs),
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {name} failed "
                                   f"(rc={r.returncode}):\n{r.stderr[-4000:]}")
            os.replace(tmp, out)
    return out
