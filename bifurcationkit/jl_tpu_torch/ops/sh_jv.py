"""Fused Swift-Hohenberg J.v: the CUDA kernel's wrapper and its plain
PyTorch version.

    J v = -(I + Lap)^2 v + (l + 2 nu u - 3 u^2) v

on an (N, M) grid, with one of two closures (`closure=`):

- "neumann" (default): the edge-replicating closure at the v level and
  again at the w = (I + Lap) v level (ref examples/SH2d-fronts.jl:20-24);
- "periodic": both Laplacians wrap around the grid, the J.v of the
  periodic model (ref examples/SH2d-fronts-cuda.jl; the JAX package takes
  it by `jvp` of `jl_tpu/models/sh.py::swift_hohenberg_periodic_2d`).

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

The launch path is lean: `sh_jv_operator(u, scal)` checks u and scal and
binds the entry point once per linearisation point (the SH model's
`jac_op` builds one per point), and each product then checks only v by
attribute compares, allocates the output and launches.  `sh_jv` called
directly checks everything on every call.

The kernel computes values only.  A CUDA operand that carries a derivative
(requires grad, is wrapped by a `torch.func` transform, or has a
forward-mode tangent) is refused, so a derivative through the kernel
never drops to zero silently; differentiate F, or the plain version on
the CPU, instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import nvcc

SOURCE = nvcc.CSRC / "sh_jv.cu"
CLOSURES = ("neumann", "periodic")
_MAX_BATCH = 65535          # gridDim.z limit
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ENTRIES = {("neumann", torch.float32): "sh_jv_f32",
            ("neumann", torch.float64): "sh_jv_f64",
            ("periodic", torch.float32): "sh_jv_periodic_f32",
            ("periodic", torch.float64): "sh_jv_periodic_f64"}


def _check_closure(closure: str):
    if closure not in CLOSURES:
        raise ValueError(f"sh_jv: closure must be one of {CLOSURES}, got "
                         f"{closure!r}")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, closure: str = "neumann"):
    """The kernel's entry point for dtype and closure, built and bound at
    first use."""
    lib = nvcc.load_library(SOURCE, {name: _SIGNATURE
                                     for name in _ENTRIES.values()})
    return getattr(lib, _ENTRIES[(closure, dtype)])


def _card_operator(u: torch.Tensor, scal: torch.Tensor,
                   closure: str = "neumann"):
    """v -> J v through the kernel, with u and scal checked here once."""
    for name, t in (("u", u), ("scal", scal)):
        nvcc.check_no_derivative("sh_jv", name, t)
        nvcc.check_operand("sh_jv", name, t, u, "u")
    if u.dim() != 2 or min(u.shape) < 1:
        raise ValueError(f"sh_jv: u must be a non-empty (N, M) field, got "
                         f"{tuple(u.shape)}")
    if scal.shape != (4,):
        raise ValueError(f"sh_jv: scal must have shape (4,), got "
                         f"{tuple(scal.shape)}")
    _check_closure(closure)
    fn = _entry(u.dtype, closure)
    device, index, dtype, field = u.device, u.get_device(), u.dtype, u.shape
    case = (closure, str(dtype).split(".")[-1])
    N, M = field
    u_ptr, scal_ptr = u.data_ptr(), scal.data_ptr()

    def op(v: torch.Tensor) -> torch.Tensor:
        if v.device != device or v.dtype is not dtype \
                or not v.is_contiguous() or v.requires_grad \
                or nvcc.autodiff_active():
            nvcc.check_no_derivative("sh_jv", "v", v)
            nvcc.check_operand("sh_jv", "v", v, u, "u")
        shape = v.shape
        if shape == field:
            K = 1
        elif len(shape) == 3 and shape[1:] == field:
            K = shape[0]
            if K > _MAX_BATCH:
                raise ValueError(f"sh_jv: batch {K} > {_MAX_BATCH}")
        else:
            raise ValueError(f"sh_jv: v must be (N, M) or (K, N, M) with "
                             f"(N, M) = {tuple(field)}, got {tuple(shape)}")
        out = torch.empty_like(v)
        if K == 0:
            return out
        err = nvcc.launch(fn, index, u_ptr, v.data_ptr(), scal_ptr,
                          out.data_ptr(), N, M, K)
        if err != 0:
            raise RuntimeError(f"sh_jv kernel launch failed: CUDA error "
                               f"{err} ({N}x{M}, K={K}, {dtype})")
        key = case + (K,)
        sh_jv.launches_by_case[key] = sh_jv.launches_by_case.get(key, 0) + 1
        return out

    op.u, op.scal = u, scal        # the pointers above stay valid with them
    return op


def sh_jv_operator(u: torch.Tensor, scal: torch.Tensor,
                   closure: str = "neumann"):
    """The map v -> J(u) v of `sh_jv` at one linearisation point.  On the
    card, u and scal are checked once here and each call checks only v;
    with u and scal on the CPU, each call is `sh_jv`."""
    if u.device.type == "cpu" and scal.device.type == "cpu":
        return lambda v: sh_jv(u, v, scal, closure)
    return _card_operator(u, scal, closure)


def sh_jv(u: torch.Tensor, v: torch.Tensor, scal: torch.Tensor,
          closure: str = "neumann") -> torch.Tensor:
    """Fused J.v.  u: (N, M); v: (N, M) or (K, N, M); scal: (4,)
    [l, nu, 1/hx^2, 1/hy^2], all of one dtype (f32 or f64); closure
    "neumann" or "periodic".

    CPU tensors take `sh_jv_plain`; CUDA tensors launch the kernel on the
    current stream (counted by (closure, dtype, K) in
    `sh_jv.launches_by_case`; `launch_count` and `launches_by_batch` read
    it) or raise."""
    if u.device.type == "cpu" and v.device.type == "cpu" \
            and scal.device.type == "cpu":
        return sh_jv_plain(u, v, scal, closure)
    return _card_operator(u, scal, closure)(v)


sh_jv.launches_by_case = {}       # (closure, dtype name, K) -> launches


def launch_count() -> int:
    """The kernel's launches so far."""
    return sum(sh_jv.launches_by_case.values())


def launches_by_batch() -> dict:
    """The kernel's launches so far by batch size K."""
    out = {}
    for (_, _, k), n in sh_jv.launches_by_case.items():
        out[k] = out.get(k, 0) + n
    return dict(sorted(out.items()))


def lap_neumann(u: torch.Tensor, h2, axis: int) -> torch.Tensor:
    """1D second difference with the reference's modified-corner (Neumann)
    closure (ref examples/SH2d-fronts.jl:20-24: D2[1,1] = -1/h^2): the
    edge value is replicated one cell beyond the border."""
    n = u.shape[axis]
    um = torch.cat([u.narrow(axis, 0, 1), u.narrow(axis, 0, n - 1)], dim=axis)
    up = torch.cat([u.narrow(axis, 1, n - 1), u.narrow(axis, n - 1, 1)],
                   dim=axis)
    return (um - 2 * u + up) / h2


def lap_periodic(u: torch.Tensor, h2, axis: int) -> torch.Tensor:
    """1D periodic second difference (JAX `_lap_periodic`,
    jl_tpu/models/sh.py:110-119)."""
    return (torch.roll(u, 1, axis) - 2 * u + torch.roll(u, -1, axis)) / h2


def sh_jv_plain(u: torch.Tensor, v: torch.Tensor, scal: torch.Tensor,
                closure: str = "neumann") -> torch.Tensor:
    """The unfused formulation (counterpart of `sh_jv_reference`,
    `jl_tpu/ops/pallas_sh.py`, and of `jax.jvp` of the periodic model's
    F); v may carry a leading batch dimension."""
    _check_closure(closure)
    l, nu, inv_hx2, inv_hy2 = scal[0], scal[1], scal[2], scal[3]
    lap1 = lap_periodic if closure == "periodic" else lap_neumann

    def lap(a):
        return lap1(a, 1.0 / inv_hx2, -2) + lap1(a, 1.0 / inv_hy2, -1)

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
