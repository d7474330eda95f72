"""ctypes binding to the repository's native C++ runtime
(``native/native.cpp``), the port's own copy of
``recsys_tpu/utils/native.py``.

The library is compiled from ``native/native.cpp`` on first use with
``g++ -O3 -std=c++17 -fPIC -shared -pthread`` into
``build/native/libnative_<hash>.so`` at the root of the checkout; the
name carries a hash of the source and the flags, so an edited source
builds anew. The port never loads, nor writes beside, the library under
``native/``. Every entry point has the numpy fallback of the JAX
package's binding, taken when the library cannot be built or loaded:

* :func:`parse_ratings_dat`: the ``user::movie::rating::timestamp``
  parser of a real ``ratings.dat``;
* :func:`topk_dot`: threaded exact top-k by dot product;
* :func:`gather_batch`: the streaming input path's threaded row gather.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "native.cpp"
BUILD_DIR = _REPO / "build" / "native"
# no -march=native: a library built on one host may be loaded on another
# (a copied checkout), and every route here is bound by memory or BLAS
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnative_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/native.cpp`` (if needed) and return the library."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(out)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr}")
        os.replace(out, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.parse_ratings_dat.restype = ctypes.c_int64
    lib.parse_ratings_dat.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.topk_dot.restype = None
    lib.topk_dot.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.gather_batch.restype = None
    lib.gather_batch.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
            logger.debug("native library loaded from %s", lib._name)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.info("native library unavailable (%s); using numpy fallbacks", e)
        return _lib


def native_available() -> bool:
    return _load() is not None


def parse_ratings_dat(path: str):
    """Parse ``user::movie::rating::timestamp`` lines, skipping malformed
    ones. -> (user_id int64, movie_id int64, rating float64, timestamp
    int64) arrays."""
    lib = _load()
    with open(path, "rb") as f:
        data = f.read()
    max_rows = data.count(b"\n") + 1
    if lib is not None:
        u = np.empty(max_rows, np.int64)
        m = np.empty(max_rows, np.int64)
        r = np.empty(max_rows, np.float64)
        t = np.empty(max_rows, np.int64)
        n = lib.parse_ratings_dat(
            data, len(data), max_rows,
            u.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if n >= 0:
            return u[:n], m[:n], r[:n], t[:n]
        logger.warning("native parser failed; falling back to numpy")
    rows = [ln.split(b"::") for ln in data.splitlines() if ln]
    arr = np.array([[f[0], f[1], f[2], f[3]] for f in rows if len(f) == 4])
    return (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
            arr[:, 2].astype(np.float64), arr[:, 3].astype(np.int64))


def topk_dot(queries: np.ndarray, items: np.ndarray, k: int,
             bias: Optional[np.ndarray] = None,
             n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k by dot product: queries [Q, d], items [N, d] (fp32),
    optional ``bias`` [N] -> (scores [Q, k], ids [Q, k] int32), in
    descending score order."""
    queries = np.ascontiguousarray(queries, np.float32)
    items = np.ascontiguousarray(items, np.float32)
    q, d = queries.shape
    n = items.shape[0]
    k = min(k, n)
    lib = _load()
    if lib is not None:
        scores = np.empty((q, k), np.float32)
        ids = np.empty((q, k), np.int32)
        bias_arr = None if bias is None else np.ascontiguousarray(bias, np.float32)
        bias_ptr = (ctypes.cast(None, ctypes.POINTER(ctypes.c_float)) if bias_arr is None
                    else bias_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        lib.topk_dot(
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), q,
            items.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
            bias_ptr, k,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_threads,
        )
        return scores, ids
    dense = queries @ items.T
    if bias is not None:
        dense = dense + bias[None, :]
    ids = np.argpartition(-dense, k - 1, axis=1)[:, :k]
    part = np.take_along_axis(dense, ids, axis=1)
    order = np.argsort(-part, axis=1)
    ids = np.take_along_axis(ids, order, axis=1).astype(np.int32)
    return np.take_along_axis(dense, ids, axis=1).astype(np.float32), ids


def gather_batch(columns, idx: np.ndarray, n_threads: int = 0):
    """``out[c][j] = columns[c][idx[j]]`` for every column (a dict of
    arrays, rows on axis 0, any dtype) through the threaded C++ gather,
    which runs without the interpreter lock; numpy fancy indexing when
    the library is unavailable. Indices out of range raise ValueError
    (the C++ gather trusts its indices)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        return {k: v[idx] for k, v in columns.items()}
    if len(idx):
        n_rows = min(len(v) for v in columns.values())
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n_rows:
            raise ValueError(
                f"gather_batch indices out of range: [{lo}, {hi}] vs {n_rows} rows")
    names = list(columns)
    srcs = [np.ascontiguousarray(columns[k]) for k in names]
    outs = [np.empty((len(idx),) + s.shape[1:], s.dtype) for s in srcs]
    n = len(names)
    src_ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    row_bytes = (ctypes.c_int64 * n)(
        *[s.dtype.itemsize * int(np.prod(s.shape[1:], dtype=np.int64)) for s in srcs])
    lib.gather_batch(n, src_ptrs, row_bytes,
                     idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     len(idx), dst_ptrs, n_threads)
    return dict(zip(names, outs))
