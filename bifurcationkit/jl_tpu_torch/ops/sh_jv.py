"""Fused Swift-Hohenberg J.v: the CUDA kernel's wrapper and its plain
PyTorch version.

    J v = -(I + Lap)^2 v + (l + 2 nu u - 3 u^2) v

on an (N, M) grid with the Neumann edge-replicating closure at the v level
and again at the w = (I + Lap) v level (ref examples/SH2d-fronts.jl:20-24).
Port of `jl_tpu/ops/pallas_sh.py` (`sh_jv_pallas` -> `sh_jv`,
`sh_jv_reference` -> `sh_jv_plain`).  The kernel (`csrc/sh_jv.cu`) takes any
(N, M), f32 or f64, and a batch of K fields v of shape (K, N, M) sharing
one u: the eigensolver applies J to a whole block in one launch.

The scalars `scal = [l, nu, 1/hx^2, 1/hy^2]` arrive as a tensor on the
field's device, so a change of the continuation parameter costs no host
sync and no rebuild.

The kernel is built at first use with `nvcc` into `build/` beside this
package and bound with ctypes (`ops/nvcc.py`).  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import nvcc

SOURCE = nvcc.CSRC / "sh_jv.cu"
_MAX_BATCH = 65535          # gridDim.z limit
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _library():
    return nvcc.load_library(SOURCE, {"sh_jv_f32": _SIGNATURE,
                                      "sh_jv_f64": _SIGNATURE})


def _check(u: torch.Tensor, v: torch.Tensor, scal: torch.Tensor):
    for name, t in (("u", u), ("v", v), ("scal", scal)):
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"sh_jv: {name} must lie on {u.device} (cuda), "
                             f"got {t.device}")
        if t.dtype not in (torch.float32, torch.float64) \
                or t.dtype != u.dtype:
            raise TypeError(f"sh_jv: {name} must be float32 or float64 and "
                            f"match u ({u.dtype}), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sh_jv: {name} must be contiguous")
    if u.dim() != 2 or min(u.shape) < 1:
        raise ValueError(f"sh_jv: u must be a non-empty (N, M) field, got "
                         f"{tuple(u.shape)}")
    if not (v.shape == u.shape
            or (v.dim() == 3 and v.shape[1:] == u.shape)):
        raise ValueError(f"sh_jv: v must be (N, M) or (K, N, M) with "
                         f"(N, M) = {tuple(u.shape)}, got {tuple(v.shape)}")
    if v.dim() == 3 and v.shape[0] > _MAX_BATCH:
        raise ValueError(f"sh_jv: batch {v.shape[0]} > {_MAX_BATCH}")
    if scal.shape != (4,):
        raise ValueError(f"sh_jv: scal must have shape (4,), got "
                         f"{tuple(scal.shape)}")


def sh_jv(u: torch.Tensor, v: torch.Tensor, scal: torch.Tensor
          ) -> torch.Tensor:
    """Fused J.v.  u: (N, M); v: (N, M) or (K, N, M); scal: (4,)
    [l, nu, 1/hx^2, 1/hy^2], all of one dtype (f32 or f64).

    CPU tensors take `sh_jv_plain`; CUDA tensors launch the kernel on the
    current stream (counted in `sh_jv.launches`) or raise."""
    if u.device.type == "cpu" and v.device.type == "cpu" \
            and scal.device.type == "cpu":
        return sh_jv_plain(u, v, scal)
    _check(u, v, scal)
    out = torch.empty_like(v)
    K = 1 if v.dim() == 2 else v.shape[0]
    if K == 0:
        return out
    N, M = u.shape
    lib = _library()
    fn = lib.sh_jv_f64 if u.dtype == torch.float64 else lib.sh_jv_f32
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), v.data_ptr(), scal.data_ptr(), out.data_ptr(),
                 N, M, K, stream)
    if err != 0:
        raise RuntimeError(f"sh_jv kernel launch failed: CUDA error {err} "
                           f"({N}x{M}, K={K}, {u.dtype})")
    sh_jv.launches += 1
    return out


sh_jv.launches = 0


def lap_neumann(u: torch.Tensor, h2, axis: int) -> torch.Tensor:
    """1D second difference with the reference's modified-corner (Neumann)
    closure (ref examples/SH2d-fronts.jl:20-24: D2[1,1] = -1/h^2): the
    edge value is replicated one cell beyond the border."""
    n = u.shape[axis]
    um = torch.cat([u.narrow(axis, 0, 1), u.narrow(axis, 0, n - 1)], dim=axis)
    up = torch.cat([u.narrow(axis, 1, n - 1), u.narrow(axis, n - 1, 1)],
                   dim=axis)
    return (um - 2 * u + up) / h2


def sh_jv_plain(u: torch.Tensor, v: torch.Tensor, scal: torch.Tensor
                ) -> torch.Tensor:
    """The unfused formulation (counterpart of `sh_jv_reference`,
    `jl_tpu/ops/pallas_sh.py`); v may carry a leading batch dimension."""
    l, nu, inv_hx2, inv_hy2 = scal[0], scal[1], scal[2], scal[3]

    def lap(a):
        return (lap_neumann(a, 1.0 / inv_hx2, -2)
                + lap_neumann(a, 1.0 / inv_hy2, -1))

    w = v + lap(v)
    L1v = w + lap(w)
    return -L1v + (l + 2.0 * nu * u - 3.0 * u * u) * v


def sh_jv_bytes(N: int, M: int, K: int, itemsize: int) -> int:
    """Bytes the function must move: u and the K fields v read once, the K
    outputs written once."""
    return (1 + 2 * K) * N * M * itemsize


def sh_jv_flops(N: int, M: int, K: int) -> int:
    """Floating-point operations per call: two 5-point stencils with their
    identity term (9 each) and the diagonal term (6) per output point."""
    return 24 * K * N * M
