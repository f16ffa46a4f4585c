"""ctypes bindings for the native host structure engine (native/qrkit_host.cpp).

Counterpart of ``qrkit_tpu/_native.py``: the same committed
``native/libqrkit_host.so``, loaded lazily.  Every caller falls back to the
NumPy implementation when the shared library is missing (``make -C native``)
or when ``QRKIT_TPU_NATIVE=0``.  This is a host engine, not a device kernel,
so the fallback is part of its contract; both paths give identical results
(tests/test_native.py, tests/test_torch_host.py).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("QRKIT_TPU_NATIVE", "1") == "0":
        return None
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native",
        "libqrkit_host.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.qrkit_abap_order.restype = ctypes.c_int
    lib.qrkit_block_detect.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return _lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64)


def _pf64(a: np.ndarray):
    return a.ctypes.data_as(_F64)


def row_ranges(nrows, ncols, indptr, indices):
    starts = np.empty(nrows, dtype=np.int64)
    ends = np.empty(nrows, dtype=np.int64)
    _lib().qrkit_row_ranges(
        ctypes.c_int64(nrows), ctypes.c_int64(ncols), _p64(indptr), _p64(indices),
        _p64(starts), _p64(ends),
    )
    return starts, ends


def abap_order(starts):
    n = starts.shape[0]
    out = np.empty(n, dtype=np.int64)
    has_perm = _lib().qrkit_abap_order(ctypes.c_int64(n), _p64(starts), _p64(out))
    return out, bool(has_perm)


def col_nnz(indices, ncols):
    counts = np.empty(ncols, dtype=np.int64)
    _lib().qrkit_col_nnz(
        ctypes.c_int64(indices.shape[0]), _p64(indices), ctypes.c_int64(ncols),
        _p64(counts),
    )
    return counts


def block_detect(nrows, ncols, starts, ends, suggested_cols):
    max_blocks = nrows + 1
    out = np.empty((max_blocks, 4), dtype=np.int64)
    nnz_q = np.zeros(1, dtype=np.int64)
    count = _lib().qrkit_block_detect(
        ctypes.c_int64(nrows), ctypes.c_int64(ncols), _p64(starts), _p64(ends),
        ctypes.c_int64(suggested_cols), _p64(out), ctypes.c_int64(max_blocks),
        _p64(nnz_q),
    )
    if count < 0:
        raise RuntimeError(f"qrkit_block_detect failed ({count})")
    return out[:count], int(nnz_q[0])


def extract_panels(nrows, ncols, indptr, indices, data, blocks, pad_rows, pad_cols):
    nb = blocks.shape[0]
    data = np.ascontiguousarray(data, dtype=np.float64)
    blocks = np.ascontiguousarray(blocks, dtype=np.int64)
    out = np.empty((nb, pad_rows, pad_cols), dtype=np.float64)
    _lib().qrkit_extract_panels(
        ctypes.c_int64(nrows), ctypes.c_int64(ncols), _p64(indptr), _p64(indices),
        _pf64(data), _p64(blocks), ctypes.c_int64(nb), ctypes.c_int64(pad_rows),
        ctypes.c_int64(pad_cols), _pf64(out),
    )
    return out


def permute_rows_csr(nrows, indptr, indices, data, gather):
    data = np.ascontiguousarray(data, dtype=np.float64)
    gather = np.ascontiguousarray(gather, dtype=np.int64)
    out_indptr = np.empty(nrows + 1, dtype=np.int64)
    out_indices = np.empty_like(indices)
    out_data = np.empty_like(data)
    _lib().qrkit_permute_rows_csr(
        ctypes.c_int64(nrows), _p64(indptr), _p64(indices), _pf64(data),
        _p64(gather), _p64(out_indptr), _p64(out_indices), _pf64(out_data),
    )
    return out_indptr, out_indices, out_data
