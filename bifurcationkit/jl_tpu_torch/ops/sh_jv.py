"""Fused Swift-Hohenberg J.v: the CUDA kernel's wrapper and its plain
PyTorch version.

    J v = -(I + Lap)^2 v + (l + 2 nu u - 3 u^2) v

on an (N, M) grid, with one of two closures (`closure=`):

- "neumann" (default): the edge-replicating closure at the v level and
  again at the w = (I + Lap) v level (ref examples/SH2d-fronts.jl:20-24);
- "periodic": both Laplacians wrap around the grid, the J.v of the
  periodic model (ref examples/SH2d-fronts-cuda.jl; the JAX package takes
  it by `jvp` of `jl_tpu/models/sh.py::swift_hohenberg_periodic_2d`).

A third closure, the halo rows (`sh_jv_halo`, plain `sh_jv_halo_plain`),
computes one row block of a Neumann field partitioned by rows over ranks
(`parallel/halo.py::sharded_sh_jv`): the caller gives the block, the 2 rows
of v above and below it, and whether its top and bottom are the field's
global edges.

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
# the halo closure: u, v, top, bot, scal, out, N, M, K, edges, stream
_HALO_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
_HALO_ENTRIES = {("halo", torch.float32): "sh_jv_halo_f32",
                 ("halo", torch.float64): "sh_jv_halo_f64"}
_TOP_EDGE, _BOTTOM_EDGE = 1, 2       # the kernel's `edges` bits


def _check_closure(closure: str):
    if closure not in CLOSURES:
        raise ValueError(f"sh_jv: closure must be one of {CLOSURES}, got "
                         f"{closure!r}")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, closure: str = "neumann"):
    """The kernel's entry point for dtype and closure, built and bound at
    first use."""
    functions = {name: _SIGNATURE for name in _ENTRIES.values()}
    functions.update({name: _HALO_SIGNATURE
                      for name in _HALO_ENTRIES.values()})
    lib = nvcc.load_library(SOURCE, functions)
    return getattr(lib, {**_ENTRIES, **_HALO_ENTRIES}[(closure, dtype)])


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


def _halo_rows(v: torch.Tensor, rows, edge: bool, at: int) -> torch.Tensor:
    """The 2 halo rows on one side of the block v (..., B, M): the given
    neighbour rows, or v's edge row `at` twice at a global edge."""
    if edge:
        return v[..., at:at + 1, :].expand(v.shape[:-2] + (2, v.shape[-1]))
    return rows


def sh_jv_halo(u: torch.Tensor, v: torch.Tensor, top, bot,
               scal: torch.Tensor, top_edge: bool,
               bottom_edge: bool) -> torch.Tensor:
    """J.v on one row block of a Neumann field partitioned by rows.

    u: the block's (B, M) linearisation point; v: (B, M) or (K, B, M);
    top, bot: the 2 rows of v above and below the block ((2, M) or
    (K, 2, M)), ignored (None allowed) where `top_edge` / `bottom_edge`
    says the block's top / bottom is the field's global edge, where the
    Neumann closure holds; scal: (4,) [l, nu, 1/hx^2, 1/hy^2].  The
    columns keep the Neumann closure.

    CPU tensors take `sh_jv_halo_plain`; CUDA tensors launch the kernel's
    halo closure on the current stream (counted by ("halo", dtype, K) in
    `sh_jv.launches_by_case`) or raise."""
    halos = [t for t, edge in ((top, top_edge), (bot, bottom_edge))
             if not edge]
    if all(t.device.type == "cpu" for t in (u, v, scal, *halos)):
        return sh_jv_halo_plain(u, v, top, bot, scal, top_edge, bottom_edge)
    for name, t in (("u", u), ("v", v), ("scal", scal)):
        nvcc.check_no_derivative("sh_jv_halo", name, t)
        nvcc.check_operand("sh_jv_halo", name, t, u, "u")
    if u.dim() != 2 or min(u.shape) < 1:
        raise ValueError(f"sh_jv_halo: u must be a non-empty (B, M) block, "
                         f"got {tuple(u.shape)}")
    if scal.shape != (4,):
        raise ValueError(f"sh_jv_halo: scal must have shape (4,), got "
                         f"{tuple(scal.shape)}")
    B, M = u.shape
    if v.shape == u.shape:
        K = 1
    elif v.dim() == 3 and v.shape[1:] == u.shape:
        K = v.shape[0]
        if K > _MAX_BATCH:
            raise ValueError(f"sh_jv_halo: batch {K} > {_MAX_BATCH}")
    else:
        raise ValueError(f"sh_jv_halo: v must be (B, M) or (K, B, M) with "
                         f"(B, M) = {tuple(u.shape)}, got {tuple(v.shape)}")
    halo_shape = v.shape[:-2] + (2, M)
    ptrs = []
    for name, t, edge in (("top", top, top_edge), ("bot", bot, bottom_edge)):
        if edge:
            ptrs.append(v.data_ptr())     # not read at a global edge
            continue
        nvcc.check_no_derivative("sh_jv_halo", name, t)
        nvcc.check_operand("sh_jv_halo", name, t, u, "u")
        if t.shape != halo_shape:
            raise ValueError(f"sh_jv_halo: {name} must have shape "
                             f"{tuple(halo_shape)}, got {tuple(t.shape)}")
        ptrs.append(t.data_ptr())
    out = torch.empty_like(v)
    if K == 0:
        return out
    edges = (_TOP_EDGE if top_edge else 0) | (_BOTTOM_EDGE if bottom_edge
                                               else 0)
    err = nvcc.launch(_entry(u.dtype, "halo"), u.get_device(), u.data_ptr(),
                      v.data_ptr(), ptrs[0], ptrs[1], scal.data_ptr(),
                      out.data_ptr(), B, M, K, edges)
    if err != 0:
        raise RuntimeError(f"sh_jv_halo kernel launch failed: CUDA error "
                           f"{err} ({B}x{M}, K={K}, edges={edges}, "
                           f"{u.dtype})")
    key = ("halo", str(u.dtype).split(".")[-1], K)
    sh_jv.launches_by_case[key] = sh_jv.launches_by_case.get(key, 0) + 1
    return out


def sh_jv_halo_plain(u: torch.Tensor, v: torch.Tensor, top, bot,
                     scal: torch.Tensor, top_edge: bool,
                     bottom_edge: bool) -> torch.Tensor:
    """The plain version of `sh_jv_halo`, written after the body of the
    JAX package's `parallel/halo.py::sharded_sh_jv` (`kernel`): the block
    extended by its halo rows, w = (I + Lap) v on the B + 2 rows around it,
    w past a global edge replaced by the edge's own w."""
    l, nu, inv_hx2, inv_hy2 = scal[0], scal[1], scal[2], scal[3]
    B = v.shape[-2]
    vext = torch.cat([_halo_rows(v, top, top_edge, 0), v,
                      _halo_rows(v, bot, bottom_edge, B - 1)], dim=-2)

    def lap_y(a):
        left = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
        right = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
        return (left - 2.0 * a + right) * inv_hy2

    lap_x = (vext[..., :-2, :] - 2.0 * vext[..., 1:-1, :]
             + vext[..., 2:, :]) * inv_hx2
    vmid = vext[..., 1:-1, :]
    w = vmid + lap_x + lap_y(vmid)                        # (B + 2) rows
    row0 = w[..., 1:2, :] if top_edge else w[..., 0:1, :]
    rowL = w[..., B:B + 1, :] if bottom_edge else w[..., B + 1:B + 2, :]
    w = torch.cat([row0, w[..., 1:B + 1, :], rowL], dim=-2)
    wmid = w[..., 1:-1, :]
    lap_wx = (w[..., :-2, :] - 2.0 * wmid + w[..., 2:, :]) * inv_hx2
    L1v = wmid + lap_wx + lap_y(wmid)
    return -L1v + (l + 2.0 * nu * u - 3.0 * u * u) * v


def sh_jv_by_blocks(u: torch.Tensor, v: torch.Tensor, scal: torch.Tensor,
                    bounds, fn=sh_jv_halo) -> torch.Tensor:
    """The Neumann J.v of a whole field computed block by block through
    the halo closure, as the ranks of a row partition compute it: block b
    is rows bounds[b]:bounds[b+1] (bounds from 0 to N, each block at least
    2 rows), given its neighbours' 2 rows and the global-edge flags.  `fn`
    is `sh_jv_halo` or `sh_jv_halo_plain`."""
    nb = len(bounds) - 1
    outs = []
    for b in range(nb):
        s0, s1 = bounds[b], bounds[b + 1]
        top = None if b == 0 else v[..., s0 - 2:s0, :].contiguous()
        bot = None if b == nb - 1 else v[..., s1:s1 + 2, :].contiguous()
        outs.append(fn(u[s0:s1].contiguous(), v[..., s0:s1, :].contiguous(),
                       top, bot, scal, b == 0, b == nb - 1))
    return torch.cat(outs, dim=-2)


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


def sh_jv_halo_bytes(B: int, M: int, K: int, itemsize: int,
                     halo_rows: int) -> int:
    """Bytes `sh_jv_halo` must move: u, the K blocks v and their
    `halo_rows` neighbour rows (4, 2 at one global edge, 0 for a whole
    field) read once, the K outputs written once."""
    return ((1 + 2 * K) * B * M + K * halo_rows * M) * itemsize


def sh_jv_flops(N: int, M: int, K: int) -> int:
    """Floating-point operations per call: two 5-point stencils with their
    identity term (9 each) and the diagonal term (6) per output point."""
    return 24 * K * N * M
