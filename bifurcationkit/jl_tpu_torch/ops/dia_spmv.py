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
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import nvcc

SOURCE = nvcc.CSRC / "dia_spmv.cu"
MAX_DIAGS = 32              # the kernel's parameter array
_MAX_BATCH = 65535          # gridDim.y limit
_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]


def _library():
    return nvcc.load_library(SOURCE, {"dia_spmv_f32": _SIGNATURE,
                                      "dia_spmv_f64": _SIGNATURE})


def _check(data: torch.Tensor, offsets: Sequence[int], v: torch.Tensor):
    for name, t in (("data", data), ("v", v)):
        if t.device.type != "cuda" or t.device != data.device:
            raise ValueError(f"dia_spmv: {name} must lie on {data.device} "
                             f"(cuda), got {t.device}")
        if t.dtype not in (torch.float32, torch.float64) \
                or t.dtype != data.dtype:
            raise TypeError(f"dia_spmv: {name} must be float32 or float64 "
                            f"and match data ({data.dtype}), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dia_spmv: {name} must be contiguous")
    if data.dim() != 2 or data.shape[0] != len(offsets):
        raise ValueError(f"dia_spmv: data must be (ndiag, n) with ndiag = "
                         f"{len(offsets)} offsets, got {tuple(data.shape)}")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"dia_spmv: {len(offsets)} diagonals > "
                         f"{MAX_DIAGS}")
    n = data.shape[1]
    if v.shape[-1:] != (n,) or v.dim() not in (1, 2):
        raise ValueError(f"dia_spmv: v must be (n,) or (K, n) with n = {n}, "
                         f"got {tuple(v.shape)}")
    if v.dim() == 2 and v.shape[0] > _MAX_BATCH:
        raise ValueError(f"dia_spmv: batch {v.shape[0]} > {_MAX_BATCH}")


def dia_spmv(A, v: torch.Tensor) -> torch.Tensor:
    """y = A v for a `DIAMatrix` A (data (ndiag, n), offsets) and v of
    shape (n,) or (K, n), of A's dtype (f32 or f64).

    CPU tensors take `dia_spmv_plain`; CUDA tensors launch the kernel on
    the current stream (counted in `dia_spmv.launches`) or raise."""
    data, offsets = A.data, A.offsets
    if data.device.type == "cpu" and v.device.type == "cpu":
        return dia_spmv_plain(A, v)
    _check(data, offsets, v)
    out = torch.empty_like(v)
    n = data.shape[1]
    K = 1 if v.dim() == 1 else v.shape[0]
    if K == 0 or n == 0:
        return out
    lib = _library()
    fn = lib.dia_spmv_f64 if data.dtype == torch.float64 else lib.dia_spmv_f32
    offs = (ctypes.c_int * max(len(offsets), 1))(*offsets)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), offs, len(offsets), v.data_ptr(),
                 out.data_ptr(), n, K, stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {err} "
                           f"(n={n}, K={K}, ndiag={len(offsets)}, "
                           f"{data.dtype})")
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
