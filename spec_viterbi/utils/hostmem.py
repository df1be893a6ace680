"""Host memory allocation tuned for this class of VM.

The level-L composition allocates multi-GB output slabs and fills them
once. On the build/serving VMs measured here, first-touch page faults on
*never-before-used* anonymous memory run at ~0.15-0.3 GB/s single-threaded
(~80 µs per 4k page — consistent with one-time page-acceptance cost on a
confidential-computing host; 2M THP faults are proportionally slow too),
while

- the same fault storm across 4 threads runs at ~2.8 GB/s (the cost
  parallelizes), and
- *recycled* pages (freed by an earlier mapping) re-fault at ~3.6 GB/s
  single-threaded, and already-faulted pages write at the full ~10 GB/s
  store bandwidth.

``populate_empty`` therefore front-loads the fault storm with a small
thread pool touching one byte per page. Small allocations keep plain
``np.empty`` (malloc arena reuse makes them cheap). Spreading first-touch
across the *fill* thread pool instead leaves the faults interleaved with
(and serializing) the compute.
"""

from __future__ import annotations

import concurrent.futures
import mmap
import os

import numpy as np

# Below this, malloc reuse beats an mmap + touch pass per allocation.
POPULATE_THRESHOLD_BYTES = 32 << 20

_PAGE = mmap.PAGESIZE


def _touch_threads() -> int:
    return min(4, os.cpu_count() or 1)


def populate_empty(shape, dtype=np.float32) -> np.ndarray:
    """``np.zeros``-contents array over eagerly-faulted pages (large slabs).

    Falls back to ``np.empty`` (uninitialized) below the size threshold —
    callers must treat contents as uninitialized either way. The mmap
    backing stays alive via the returned array's ``base``.
    """
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if nbytes < POPULATE_THRESHOLD_BYTES:
        return np.empty(shape, dtype)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    flat = np.frombuffer(buf, dtype=np.uint8)
    nt = _touch_threads()
    bounds = np.linspace(0, nbytes, nt + 1, dtype=np.int64)

    def touch(i: int) -> None:
        flat[bounds[i] : bounds[i + 1] : _PAGE] = 0

    if nt > 1:
        with concurrent.futures.ThreadPoolExecutor(max_workers=nt) as pool:
            list(pool.map(touch, range(nt)))
    else:
        touch(0)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)
