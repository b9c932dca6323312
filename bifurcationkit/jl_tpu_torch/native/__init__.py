"""Native (C++) host utilities, loaded with ctypes — the port of
`jl_tpu/native/__init__.py`.

The port keeps its own copy of the source (`csrc/bktpu_native.cpp`).  It
is compiled with g++ at first use into `build/libbktpu_<hash>.so` beside
the package (gitignored; rebuilt when the source changes).  Every entry
point has a pure-Python fallback, used with a warning where no library
can be built, so the package works without a toolchain; `loaded()` says
whether the compiled library is in use.  Host code only: no kernel of the
device path lives here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bktpu_native.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "bk_csr_max_row": (ctypes.c_int64, [_i64p, ctypes.c_int64]),
    "bk_csr_to_ell": (None, [ctypes.c_int64, _i64p, _i64p, _f64p,
                             ctypes.c_int64, _f64p, _i32p]),
    "bk_csr_diagonals": (ctypes.c_int64, [ctypes.c_int64, _i64p, _i64p,
                                          _i64p, ctypes.c_int64]),
    "bk_csr_to_dia": (None, [ctypes.c_int64, _i64p, _i64p, _f64p, _i64p,
                             ctypes.c_int64, _f64p]),
    "bk_log_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64]),
    "bk_log_append": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64,
                                     _f64p]),
    "bk_log_close": (None, [ctypes.c_void_p]),
    "bk_log_read": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, _i64p,
                                     _f64p, ctypes.c_int64]),
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbktpu_{digest}.so"


def _build() -> Path:
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)      # atomic: another process sees all or none
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    except Exception as e:  # no toolchain: the Python fallbacks below
        warnings.warn(f"native library unavailable ({e}); using Python "
                      "fallbacks")
        _lib = None
    return _lib


def loaded() -> bool:
    """Whether the compiled library is in use (built at first call)."""
    return _load() is not None


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def _csr(indptr, indices, data):
    return (_i64(indptr), _i64(indices),
            np.ascontiguousarray(data, dtype=np.float64))


def csr_to_ell_arrays(indptr, indices, data):
    """CSR arrays -> (ell_data (n,k), ell_cols (n,k)); native when
    possible."""
    indptr, indices, data = _csr(indptr, indices, data)
    n = len(indptr) - 1
    lib = _load()
    if lib is not None:
        k = int(lib.bk_csr_max_row(_ptr(indptr, _i64p), n))
        out_data = np.zeros((n, k))
        out_cols = np.full((n, k), -1, np.int32)
        lib.bk_csr_to_ell(n, _ptr(indptr, _i64p), _ptr(indices, _i64p),
                          _ptr(data, _f64p), k, _ptr(out_data, _f64p),
                          _ptr(out_cols, _i32p))
        return out_data, out_cols
    k = int(np.diff(indptr).max())
    out_data = np.zeros((n, k))
    out_cols = np.full((n, k), -1, np.int32)
    for i in range(n):
        w = indptr[i + 1] - indptr[i]
        out_data[i, :w] = data[indptr[i]:indptr[i + 1]]
        out_cols[i, :w] = indices[indptr[i]:indptr[i + 1]]
    return out_data, out_cols


def csr_to_dia_arrays(indptr, indices, data):
    """CSR arrays -> (dia_data (ndiags, n), offsets tuple)."""
    indptr, indices, data = _csr(indptr, indices, data)
    n = len(indptr) - 1
    lib = _load()
    if lib is not None:
        offs = np.zeros(2 * n + 1, np.int64)
        cnt = int(lib.bk_csr_diagonals(n, _ptr(indptr, _i64p),
                                       _ptr(indices, _i64p),
                                       _ptr(offs, _i64p), 2 * n + 1))
        offs = np.ascontiguousarray(offs[:cnt])
        out = np.zeros((cnt, n))
        lib.bk_csr_to_dia(n, _ptr(indptr, _i64p), _ptr(indices, _i64p),
                          _ptr(data, _f64p), _ptr(offs, _i64p), cnt,
                          _ptr(out, _f64p))
        return out, tuple(int(o) for o in offs)
    offsets = sorted({int(indices[p] - i) for i in range(n)
                      for p in range(indptr[i], indptr[i + 1])})
    out = np.zeros((len(offsets), n))
    slot = {o: d for d, o in enumerate(offsets)}
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            out[slot[int(indices[p] - i)], i] = data[p]
    return out, tuple(offsets)


class BranchLog:
    """Append-only binary continuation log (native streaming writer).

    Record = (step, fixed-size float64 vector); survives crashes (each
    append is flushed) and supports resume via `read`.  The file layout is
    the JAX package's: a log written by either package reads in the
    other."""

    def __init__(self, path: str, n_values: int):
        self.path = path
        self.n_values = n_values
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.bk_log_open(path.encode(), n_values)
            if not self._h:
                raise OSError(f"cannot open {path}")
        else:
            self._f = open(path, "ab")

    def append(self, step: int, values):
        values = np.ascontiguousarray(values, dtype=np.float64)
        assert values.size == self.n_values
        if self._lib is not None:
            rc = self._lib.bk_log_append(self._h, int(step),
                                         _ptr(values, _f64p))
            if rc != 0:
                raise OSError(f"log append failed rc={rc}")
        else:
            np.array([step, self.n_values], np.int64).tofile(self._f)
            values.tofile(self._f)
            self._f.flush()

    def close(self):
        if self._lib is not None and self._h:
            self._lib.bk_log_close(self._h)
            self._h = None
        elif getattr(self, "_f", None):
            self._f.close()
            self._f = None

    @classmethod
    def read(cls, path: str, n_values: int):
        lib = _load()
        if lib is not None:
            # first pass to count
            cnt = int(lib.bk_log_read(path.encode(), n_values,
                                      _ptr(np.zeros(1, np.int64), _i64p),
                                      _ptr(np.zeros(n_values), _f64p), 0))
            if cnt < 0:
                raise OSError(f"cannot read {path}")
            steps = np.zeros(cnt, np.int64)
            values = np.zeros((cnt, n_values))
            lib.bk_log_read(path.encode(), n_values, _ptr(steps, _i64p),
                            _ptr(values, _f64p), cnt)
            return steps, values
        raw = np.fromfile(path, dtype=np.uint8)
        rec = 16 + 8 * n_values
        cnt = len(raw) // rec
        steps = np.zeros(cnt, np.int64)
        values = np.zeros((cnt, n_values))
        for i in range(cnt):
            chunk = raw[i * rec:(i + 1) * rec]
            steps[i] = np.frombuffer(chunk[:8], np.int64)[0]
            values[i] = np.frombuffer(chunk[16:], np.float64)
        return steps, values
