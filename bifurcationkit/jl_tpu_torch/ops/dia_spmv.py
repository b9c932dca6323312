"""DIA sparse matrix times vector: the CUDA kernel's wrapper and its plain
PyTorch version.

    y[i] = sum_k data[k, i] * v[i + off_k],   v zero outside [0, n)

Port of `jl_tpu/ops/pallas_spmv.py` (`dia_spmv_pallas` -> `dia_spmv`; the
pad+slice `DIAMatrix.matvec` of `jl_tpu/ops/sparse.py` -> `dia_spmv_plain`).
The kernel (`csrc/dia_spmv.cu`) takes any n, any offsets (at most
`MAX_DIAGS` of them), f32 or f64, and a batch v of shape (K, n) sharing
one `data`: the eigensolver applies J to a whole block in one launch.

The JAX package's `dia_spmv(use_pallas=...)` opt-in is not carried over:
on the card the kernel is the path for every CUDA tensor.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
The kernel is built at first use with `nvcc` (`ops/nvcc.py`).

The kernel computes values only: a CUDA `data` or v that carries a
derivative (requires grad, a `torch.func` transform, a forward-mode
tangent) is refused rather than having its derivative dropped.

The launch path is lean and keeps no state on the matrix: each product
checks `data` and v by attribute compares (the full checks, with their
messages, run only when one fails), takes the entry point for the dtype
and the offsets as a C array from caches keyed by dtype and by offsets,
allocates the output and launches.  What the matrix holds at the call is
what the kernel reads.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from . import nvcc

SOURCE = nvcc.CSRC / "dia_spmv.cu"
MAX_DIAGS = 32              # the kernel's parameter array
_MAX_BATCH = 65535          # gridDim.y limit
_DTYPES = (torch.float32, torch.float64)
_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's entry point for dtype, built and bound at first use."""
    lib = nvcc.load_library(SOURCE, {"dia_spmv_f32": _SIGNATURE,
                                     "dia_spmv_f64": _SIGNATURE})
    return lib.dia_spmv_f64 if dtype == torch.float64 else lib.dia_spmv_f32


@functools.lru_cache(maxsize=None)
def _c_offsets(offsets: tuple):
    """The offsets as a C int array and its address, built once per set of
    offsets (the array lives in this cache)."""
    arr = (ctypes.c_int * max(len(offsets), 1))(*offsets)
    return arr, ctypes.addressof(arr)


def dia_spmv(A, v: torch.Tensor) -> torch.Tensor:
    """y = A v for a `DIAMatrix` A (data (ndiag, n), offsets) and v of
    shape (n,) or (K, n), of A's dtype (f32 or f64).

    CPU tensors take `dia_spmv_plain`; CUDA tensors launch the kernel on
    the current stream (counted in `dia_spmv.launches`) or raise."""
    data, offsets = A.data, A.offsets
    if data.device.type == "cpu" and v.device.type == "cpu":
        return dia_spmv_plain(A, v)
    dtype = data.dtype
    if not (data.is_cuda and v.device == data.device and v.dtype is dtype
            and dtype in _DTYPES and v.is_contiguous()
            and data.is_contiguous()) or data.requires_grad \
            or v.requires_grad or nvcc.autodiff_active():
        for name, t in (("data", data), ("v", v)):
            nvcc.check_no_derivative("dia_spmv", name, t)
            nvcc.check_operand("dia_spmv", name, t, data, "data")
    ndiag, dshape, shape = len(offsets), data.shape, v.shape
    if len(dshape) != 2 or dshape[0] != ndiag:
        raise ValueError(f"dia_spmv: data must be (ndiag, n) with ndiag "
                         f"= {ndiag} offsets, got {tuple(dshape)}")
    if ndiag > MAX_DIAGS:
        raise ValueError(f"dia_spmv: {ndiag} diagonals > {MAX_DIAGS}")
    n = dshape[1]
    if len(shape) == 1 and shape[0] == n:
        K = 1
    elif len(shape) == 2 and shape[1] == n:
        K = shape[0]
        if K > _MAX_BATCH:
            raise ValueError(f"dia_spmv: batch {K} > {_MAX_BATCH}")
    else:
        raise ValueError(f"dia_spmv: v must be (n,) or (K, n) with n = {n}, "
                         f"got {tuple(shape)}")
    out = torch.empty_like(v)
    if K == 0 or n == 0:
        return out
    err = nvcc.launch(_entry(dtype), data.get_device(), data.data_ptr(),
                      _c_offsets(tuple(offsets))[1], ndiag, v.data_ptr(),
                      out.data_ptr(), n, K)
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {err} "
                           f"(n={n}, K={K}, ndiag={ndiag}, {dtype})")
    dia_spmv.launches += 1
    return out


dia_spmv.launches = 0


def dia_spmv_plain(A, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's pad+slice formulation (`DIAMatrix.matvec`,
    `jl_tpu/ops/sparse.py`): each diagonal multiplies a zero-padded shift
    of v, so out-of-band entries of `data` meet zeros.  v may carry a
    leading batch dimension."""
    out = None
    for k, off in enumerate(A.offsets):
        if off == 0:
            shifted = v
        elif off > 0:
            shifted = F.pad(v, (0, off))[..., off:]
        else:
            shifted = F.pad(v, (-off, 0))[..., :off]
        term = A.data[k] * shifted
        out = term if out is None else out + term
    return out


def in_band(n: int, offsets: Sequence[int]) -> int:
    """Entries of an (ndiag, n) DIA `data` whose column lies in [0, n)."""
    return sum(max(n - abs(off), 0) for off in offsets)


def dia_spmv_bytes(n: int, offsets: Sequence[int], K: int,
                   itemsize: int) -> int:
    """Bytes the function must move: the in-band entries of `data` and the
    K vectors v read once, the K outputs written once."""
    return (in_band(n, offsets) + 2 * K * n) * itemsize


def dia_spmv_flops(n: int, offsets: Sequence[int], K: int) -> int:
    """Floating-point operations per call: a multiply and an add for each
    in-band entry and vector."""
    return 2 * K * in_band(n, offsets)
