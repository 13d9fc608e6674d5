"""Build-on-first-use for the port's shared libraries.

Each library is compiled into peregrine_tpu_torch/build/ under a name that
carries a hash of its sources and compile command, so an edited source
rebuilds and an unchanged one is reused.  A file lock serialises
concurrent builders (several test workers import the package at once) and
the finished library is renamed into place, so no process ever loads a
half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
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


_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def load_cuda(name: str, source: str, signatures: dict) -> ctypes.CDLL:
    """Build `source` with nvcc for sm_90a (once per source hash) and load
    it, each C entry of `signatures` with its argtypes and an int result
    (a CUDA error code)."""
    lib = ctypes.CDLL(build_shared(name, [source], [_nvcc()] + _NVCC_FLAGS))
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
