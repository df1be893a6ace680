"""ctypes loader for the native C++ parser library.

Every entry point returns ``None`` when the shared library is unavailable so
callers fall back to the pure-Python parsers (``spec_viterbi/io``). Set
``SVT_DISABLE_NATIVE=1`` to force the Python path (used in tests to compare
both parsers).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_NAME = "libsvt_native.so"
_lib = None
_lib_tried = False


def _build():
    """Lazy one-shot build of the native library (single TU, ~1 s)."""
    import subprocess

    src_dir = os.path.join(os.path.dirname(__file__), "src")
    try:
        subprocess.run(
            ["make", "-C", src_dir],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        pass  # no toolchain → Python parsers carry on


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("SVT_DISABLE_NATIVE"):
        return None
    path = os.path.join(os.path.dirname(__file__), _LIB_NAME)
    if not os.path.exists(path):
        _build()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    try:
        _bind(lib)
    except AttributeError:
        # stale .so missing entry points: fall back to the Python parsers
        return None

    _lib = lib
    return _lib


def _bind(lib) -> None:
    lib.svt_read_hmm.restype = ctypes.c_void_p
    lib.svt_read_hmm.argtypes = [ctypes.c_char_p]
    lib.svt_hmm_dims.restype = None
    lib.svt_hmm_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.svt_hmm_fill.restype = None
    lib.svt_hmm_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),   # trans_rows
        ctypes.POINTER(ctypes.c_int64),   # trans_cols
        ctypes.POINTER(ctypes.c_float),   # trans_probs
        ctypes.POINTER(ctypes.c_float),   # emissions [E*N]
        ctypes.POINTER(ctypes.c_int64),   # start_cols
        ctypes.POINTER(ctypes.c_float),   # start_probs
    ]
    lib.svt_hmm_free.restype = None
    lib.svt_hmm_free.argtypes = [ctypes.c_void_p]

    lib.svt_read_ess.restype = ctypes.c_void_p
    lib.svt_read_ess.argtypes = [ctypes.c_char_p]
    lib.svt_ess_dims.restype = None
    lib.svt_ess_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.svt_ess_lengths.restype = None
    lib.svt_ess_lengths.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.svt_ess_fill.restype = None
    lib.svt_ess_fill.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.svt_ess_free.restype = None
    lib.svt_ess_free.argtypes = [ctypes.c_void_p]


def native_available() -> bool:
    return _load() is not None


def read_hmm_native(path: str):
    """Parse a .chmm via the C++ library; None if unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.svt_read_hmm(path.encode())
    if not handle:
        return None  # parse error → Python parser raises a precise error
    try:
        dims = (ctypes.c_int64 * 4)()
        lib.svt_hmm_dims(handle, dims)
        n, e, t, s = (int(d) for d in dims)
        trans_rows = np.empty(t, dtype=np.int64)
        trans_cols = np.empty(t, dtype=np.int64)
        trans_probs = np.empty(t, dtype=np.float32)
        emissions = np.empty((e, n), dtype=np.float32)
        start_cols = np.empty(s, dtype=np.int64)
        start_probs = np.empty(s, dtype=np.float32)
        lib.svt_hmm_fill(
            handle,
            trans_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            trans_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            trans_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            emissions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            start_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            start_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    finally:
        lib.svt_hmm_free(handle)

    from spec_viterbi.hmm import HMM

    hmm = HMM(
        states_num=n,
        emit_num=e,
        trans_rows=trans_rows,
        trans_cols=trans_cols,
        trans_probs=trans_probs,
        emissions=emissions,
        start_probabilities_cols=start_cols,
        start_probabilities=start_probs,
    )
    hmm.validate()
    return hmm


def read_ess_native(path: str):
    """Parse an .ess via the C++ library; None if unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.svt_read_ess(path.encode())
    if not handle:
        return None
    try:
        dims = (ctypes.c_int64 * 2)()
        lib.svt_ess_dims(handle, dims)
        count, total = int(dims[0]), int(dims[1])
        lengths = np.empty(count, dtype=np.int64)
        lib.svt_ess_lengths(handle, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        flat = np.empty(total, dtype=np.int32)
        lib.svt_ess_fill(handle, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.svt_ess_free(handle)
    out = []
    off = 0
    for length in lengths:
        out.append(flat[off : off + int(length)].copy())
        off += int(length)
    return out
