"""ctypes bindings to the native runtime (native/ingest.cpp).

The hot host-side paths — edge-list parsing and big TSV emission — run in
C++ (multithreaded mmap scanner, buffered writers), mirroring the
reference's C++ data layer (reference: Network::read, src/network.cc:10-159;
save_model writers, src/linksampling.cc:804-837). Python/numpy fallbacks
keep everything working when the shared library hasn't been built; the
library is built on first use, and rebuilt when it is older than its
sources, when a toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libsvinet_native.so")

_lib = None
_lock = threading.Lock()
_build_attempted = False


def _stale() -> bool:
    """True when the library is missing or older than a source it is
    built from (a library built elsewhere, or before an edit, is rebuilt
    rather than loaded)."""
    if not os.path.exists(_SO_PATH):
        return True
    built = os.path.getmtime(_SO_PATH)
    return any(os.path.getmtime(os.path.join(_NATIVE_DIR, src)) > built
               for src in ("ingest.cpp", "Makefile"))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        if _stale() and not _build_attempted:
            _build_attempted = True
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        if not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.svinet_parse_ints.restype = ctypes.POINTER(ctypes.c_int64)
        lib.svinet_parse_ints.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.svinet_free.argtypes = [ctypes.c_void_p]
        lib.svinet_write_matrix_tsv.restype = ctypes.c_int
        lib.svinet_write_matrix_tsv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.svinet_write_edges_tsv.restype = ctypes.c_int
        lib.svinet_write_edges_tsv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        if hasattr(lib, "svinet_write_matrix_tsv_extra"):
            lib.svinet_write_matrix_tsv_extra.restype = ctypes.c_int
            lib.svinet_write_matrix_tsv_extra.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64)]
        if hasattr(lib, "svinet_preprocess_neighbors"):
            lib.svinet_preprocess_neighbors.restype = ctypes.c_int
            lib.svinet_preprocess_neighbors.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


def parse_ints(path: str, nthreads: int = 0) -> Optional[np.ndarray]:
    """Parse all whitespace/comma-separated integers in a file.
    Returns an int64 array, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    count = ctypes.c_int64(0)
    ptr = lib.svinet_parse_ints(path.encode(), ctypes.byref(count), nthreads)
    if not ptr:
        return None
    try:
        out = np.ctypeslib.as_array(ptr, shape=(count.value,)).copy()
    finally:
        lib.svinet_free(ptr)
    return out


def write_matrix_tsv(path: str, m: np.ndarray,
                     ext_ids: Optional[np.ndarray] = None,
                     decimals: int = 5) -> bool:
    """Fast `<seq>\\t<ext>\\t<vals...>` writer; returns False if the
    native library is unavailable (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        return False
    m = np.ascontiguousarray(m, np.float32)
    n, k = m.shape
    ids = None
    if ext_ids is not None:
        ids_arr = np.ascontiguousarray(ext_ids, np.int64)
        ids = ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.svinet_write_matrix_tsv(
        path.encode(), m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, k, ids, decimals)
    return rc == 0


def write_matrix_tsv_extra(path: str, m: np.ndarray,
                           ext_ids: Optional[np.ndarray],
                           extra: np.ndarray, decimals: int = 3) -> bool:
    """`<seq>\\t<ext>\\t<vals...>\\t<extra>` writer (groups.txt schema);
    returns False if the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "svinet_write_matrix_tsv_extra"):
        return False
    m = np.ascontiguousarray(m, np.float32)
    n, k = m.shape
    ids = None
    if ext_ids is not None:
        ids_arr = np.ascontiguousarray(ext_ids, np.int64)
        ids = ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    extra_arr = np.ascontiguousarray(extra, np.int64)
    rc = lib.svinet_write_matrix_tsv_extra(
        path.encode(), m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, k, ids, decimals,
        extra_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return rc == 0


def preprocess_neighbors(path: str, row_ptr: np.ndarray, col_idx: np.ndarray,
                         limit: int = 100, per_neighbor: int = 10,
                         nthreads: int = 0) -> bool:
    """Write neighbors.bin (reference binary layout) via the parallel C++
    2-hop walk; returns False if the native library is unavailable or
    lacks the symbol (caller falls back to the Python walk)."""
    lib = _load()
    if lib is None or not hasattr(lib, "svinet_preprocess_neighbors"):
        return False
    rp = np.ascontiguousarray(row_ptr, np.int64)
    ci = np.ascontiguousarray(col_idx, np.int32)
    rc = lib.svinet_preprocess_neighbors(
        path.encode(), rp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(rp) - 1, limit, per_neighbor, nthreads)
    return rc == 0


def write_edges_tsv(path: str, edges: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    e = np.ascontiguousarray(edges, np.int64)
    rc = lib.svinet_write_edges_tsv(
        path.encode(), e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.shape[0])
    return rc == 0
