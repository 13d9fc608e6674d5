"""Binary (de)serializers for the reference's on-disk ABI (SURVEY.md §2.4).

* mmlist files (``*-L{0,1,2}-cc-of-tt.dat``): ``size_t n`` header followed by
  n × 16-byte mm128_t{uint64 x, uint64 y} (src/shmr_utils.c:98-123).
* minimizer-count files (``*-MC-cc-of-tt.dat``): ``size_t n`` header followed
  by n × sizeof(mm_count_t) records; mm_count_t{uint64 mer; uint32 count} is
  padded to 16 bytes by C struct alignment (src/shmr_utils.c:178-203).
"""

from __future__ import annotations

import numpy as np

_MM128 = np.dtype([("x", "<u8"), ("y", "<u8")])
_MMCOUNT = np.dtype({"names": ["mer", "count"],
                     "formats": ["<u8", "<u4"],
                     "offsets": [0, 8],
                     "itemsize": 16})


def write_mmlist(path: str, x: np.ndarray, y: np.ndarray) -> None:
    rec = np.empty(len(x), dtype=_MM128)
    rec["x"] = x
    rec["y"] = y
    with open(path, "wb") as f:
        f.write(np.uint64(len(rec)).tobytes())
        rec.tofile(f)


def read_mmlist(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), dtype="<u8")[0])
        rec = np.fromfile(f, dtype=_MM128, count=n)
    return rec["x"].copy(), rec["y"].copy()


def write_mm_count(path: str, mers: np.ndarray, counts: np.ndarray) -> None:
    rec = np.zeros(len(mers), dtype=_MMCOUNT)
    rec["mer"] = mers
    rec["count"] = counts
    with open(path, "wb") as f:
        f.write(np.uint64(len(rec)).tobytes())
        rec.tofile(f)


def read_mm_count(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), dtype="<u8")[0])
        rec = np.fromfile(f, dtype=_MMCOUNT, count=n)
    return rec["mer"].copy(), rec["count"].copy()
