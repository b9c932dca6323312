"""Explicit halo exchange over a device mesh — the port of
`jl_tpu/parallel/halo.py` on `torch.distributed`.

`sharded_dia_spmv` row-partitions a DIA matrix over the mesh's `space`
axis and `sharded_sh_jv` the fused Swift-Hohenberg J.v: each rank posts
the sends and receives of its halo (the edge entries its neighbours need,
`batch_isend_irecv`) before its local work, then runs the product on its
block with the halo through the port's kernels — `dia_spmv` on the
extended vector, `sh_jv`'s halo closure (`ops/sh_jv.py::sh_jv_halo`).
`pdot` / `pnorm` are the mesh reductions (`lax.psum` in the JAX package).

Each function has a global form, as in the JAX package (global tensors or
DTensors in, a DTensor out), and a rank-local one (`*_local`: this rank's
block in and out), which the solver stack and the dry run use.  How the
halos travel is `mesh.transport`: through pinned host buffers for CUDA
tensors over gloo.  The halos of the global ends are zeros (DIA) or the
edge row replicated (SH, the Neumann closure).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..ops.dia_spmv import dia_spmv
from ..ops.sh_jv import sh_jv_halo
from ..ops.sparse import DIAMatrix
from .mesh import (_placements, _staged, all_reduce, axis_info,
                   host_buffer, local_block, to_host)


def pdot(x, y, axis: str = "space", mesh: DeviceMesh = None):
    """Global dot product of `axis`-partitioned blocks: the local sum, then
    an `all_reduce` over the ranks of `axis` (of `mesh`, or of the mesh of
    the enclosing `use_mesh`)."""
    return all_reduce(torch.sum(x * y), "sum", mesh=mesh, axis=axis)


def pnorm(x, axis: str = "space", mesh: DeviceMesh = None):
    return torch.sqrt(all_reduce(torch.sum(x * x), "sum", mesh=mesh,
                                 axis=axis))


class _Halo:
    """Posted halo transfers of one exchange; `wait()` returns the halos
    (from the previous rank, from the next rank), None past the global
    ends, on the block's device."""

    def __init__(self, works, recv, device, staged):
        self._works, self._recv = works, recv
        self._device, self._staged = device, staged

    def wait(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        for w in self._works:
            w.wait()
        if self._staged:
            return tuple(None if r is None else r.to(self._device)
                         for r in self._recv)
        return self._recv


def post_halo(mesh: DeviceMesh, x: torch.Tensor, h: int,
              axis: str = "space", dim: int = -1) -> _Halo:
    """Post the exchange of the h-wide edges of this rank's block x along
    `dim` with its neighbours on `axis` (all sends and receives at once),
    without waiting for it."""
    _, _, prev, nxt = axis_info(mesh, axis)
    group = mesh.get_group(axis)
    staged = _staged(group, x.device)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = h
    ops, recv = [], [None, None]
    for side, (peer, start) in enumerate(((prev, 0), (nxt, n - h))):
        if peer is None:
            continue
        edge = x.narrow(dim, start, h).contiguous()
        if staged:
            edge = to_host(edge, f"halo_send{side}")
            buf = host_buffer(shape, x.dtype, f"halo_recv{side}")
        else:
            buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        recv[side] = buf
        ops.append(dist.P2POp(dist.isend, edge, peer, group))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Halo(works, recv, x.device, staged)


def _halo_width(offsets) -> int:
    return max(max(0, -min(offsets)), max(0, max(offsets)), 1)


def sharded_dia_spmv_local(mesh: DeviceMesh, data: torch.Tensor, offsets,
                           v: torch.Tensor, axis: str = "space"
                           ) -> torch.Tensor:
    """This rank's rows of A v for a row-partitioned DIA matrix: `data` the
    rank's (ndiag, local) columns of A.data, v its (local,) or (K, local)
    block.  The halo (the h = max |offset| entries of v on either side)
    is posted first; then `dia_spmv` runs on the extended vector (local +
    2h, `data` padded with zeros on the halo rows) and the middle rows are
    kept.  Halos past the global ends are zeros."""
    local = v.shape[-1]
    h = _halo_width(offsets)
    assert h <= local, "halo wider than the local block"
    halo = post_halo(mesh, v, h, axis)
    data_ext = F.pad(data, (h, h))
    prev, nxt = halo.wait()
    zeros = v.new_zeros(v.shape[:-1] + (h,))
    v_ext = torch.cat([zeros if prev is None else prev, v,
                       zeros if nxt is None else nxt], dim=-1)
    out = dia_spmv(DIAMatrix(data_ext, tuple(offsets)), v_ext)
    return out[..., h:h + local]


def _local(mesh, x, axis, dim):
    return x.to_local() if isinstance(x, DTensor) \
        else local_block(mesh, x, axis, dim)


def sharded_dia_spmv(mesh: DeviceMesh, A: DIAMatrix, v, axis: str = "space"):
    """Row-partitioned DIA SpMV with explicit halo exchange: A global
    (its `data` on every rank), v a global tensor or a DTensor sharded
    along its last dimension over `axis`; returns the DTensor of A v.

    Requires every |offset| <= local block size.  Zero (Dirichlet-style)
    boundaries: the halos past the global ends are zeros."""
    n = v.shape[-1]
    _, nshards, _, _ = axis_info(mesh, axis)
    assert n % nshards == 0, "state size must divide the mesh axis"
    dim = v.dim() - 1
    data = A.data.to_local() if isinstance(A.data, DTensor) else A.data
    out = sharded_dia_spmv_local(mesh, local_block(mesh, data, axis, 1),
                                 A.offsets, _local(mesh, v, axis, dim), axis)
    return DTensor.from_local(out, mesh, _placements(mesh, axis, dim),
                              run_check=False, shape=v.shape,
                              stride=v.stride())


def sharded_sh_jv_local(mesh: DeviceMesh, u: torch.Tensor, v: torch.Tensor,
                        scal: torch.Tensor, axis: str = "space"
                        ) -> torch.Tensor:
    """This rank's rows of the Neumann SH J.v on a field partitioned by
    rows: u (B, M), v (B, M) or (K, B, M) the rank's blocks, B >= 2.  The
    2-row halo of v is posted first; the product is `sh_jv_halo` with the
    global edges flagged on the first and last ranks."""
    assert v.shape[-2] >= 2, "the row block must hold at least 2 rows"
    halo = post_halo(mesh, v, 2, axis, dim=-2)
    top, bot = halo.wait()
    return sh_jv_halo(u, v, top, bot, scal, top is None, bot is None)


def sharded_sh_jv(mesh: DeviceMesh, u, v, scal, axis: str = "space"):
    """Row-partitioned fused Swift-Hohenberg J.v over the mesh: the
    multi-device version of `ops/sh_jv.py::sh_jv` (Neumann), exactly the
    single-device operator.  u, v: (N, M) global tensors or DTensors
    sharded by rows over `axis`; scal: (4,) = [l, nu, 1/hx2, 1/hy2].
    Returns the DTensor of J v."""
    N, M = u.shape
    _, nshards, _, _ = axis_info(mesh, axis)
    assert N % nshards == 0 and N // nshards >= 2
    scal = scal.to_local() if isinstance(scal, DTensor) else scal
    out = sharded_sh_jv_local(mesh, _local(mesh, u, axis, 0),
                              _local(mesh, v, axis, 0), scal, axis)
    return DTensor.from_local(out, mesh, _placements(mesh, axis, 0),
                              run_check=False, shape=v.shape,
                              stride=v.stride())


def sharded_gmres_matvec(mesh: DeviceMesh, A: DIAMatrix, axis: str = "space"):
    """Matvec closure for the Krylov solvers: global tensors in, the
    DTensor of A v out."""

    def mv(v):
        return sharded_dia_spmv(mesh, A, v, axis=axis)

    return mv
