"""Device-mesh helpers — the port of `jl_tpu/parallel/mesh.py` on
`torch.distributed`.

The framework's two parallel axes, as in the JAX package:

* ``space``  — row/block partition of the PDE state: each rank holds a
  block of rows, the stencil and SpMV halos are exchanged between
  neighbouring ranks (`halo.py`);
* ``branch`` — embarrassingly parallel work units.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over processes
that the caller has already joined with `init_process_group`.  A global
state is a DTensor (`shard_state`, `replicated`): the counterpart of a
`NamedSharding`.

The JAX package leaves the solver stack's reductions to XLA, which
inserts the collectives for sharded arrays.  Here each rank runs the
solver on its own block (`DTensor.to_local()`, or `local_block`) inside
`use_mesh(mesh)`, which routes every reduction of the solver stack
(`core/state.py::allreduce`) through an `all_reduce` over the `space`
ranks; the models' F and J.v exchange their halos explicitly
(`parallel/models.py`).

Transport.  PyTorch's backend table gives gloo CUDA tensors for
`broadcast` and `all_reduce` only (no point-to-point sends), and NCCL
refuses two ranks on one card.  So with CUDA tensors over a gloo group the data goes
through pinned host buffers: each reduction's partial sums and each halo
are copied to the host, exchanged, and copied back; all compute stays on
the card.  Over an NCCL group the device tensors go directly (that path
has not run: the machine with the card has one).  `transport` names the
one in use.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import resolve_device
from ..core import state as _state


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("branch", "space"),
              device=None) -> DeviceMesh:
    """A mesh over the ranks of the default process group, which the
    caller has initialised.

    Default: all ranks on the `space` axis (a 1 x N mesh), matching the
    row-partitioned SpMV; pass shape=(b, s) for branch x space hybrids.
    `device=None` means the card (raises where there is none)."""
    dev = resolve_device(device)
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    assert int(np.prod(shape)) == n, f"mesh shape {shape} != {n} ranks"
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def axis_info(mesh: DeviceMesh, axis: str = "space"):
    """(index, size, previous rank, next rank) of this rank along `axis`;
    the neighbours are global ranks, None past the global ends."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    size = mesh.size(dim)
    me = coord[dim]

    def at(i):
        c = list(coord)
        c[dim] = i
        return int(mesh.mesh[tuple(c)])

    return (me, size, at(me - 1) if me > 0 else None,
            at(me + 1) if me < size - 1 else None)


def _placements(mesh: DeviceMesh, axis: str, dim: int):
    return [Shard(dim) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def local_block(mesh: DeviceMesh, x: torch.Tensor, axis: str = "space",
                dim: int = 0) -> torch.Tensor:
    """This rank's block of the global tensor x split along `dim` over
    `axis` (`torch.chunk`, as a DTensor's `Shard(dim)` splits)."""
    me, size, _, _ = axis_info(mesh, axis)
    return torch.chunk(x, size, dim)[me].contiguous()


def shard_state(mesh: DeviceMesh, u: torch.Tensor, axis: str = "space",
                dim: int = 0) -> DTensor:
    """Place a global state (the same tensor on every rank) on the mesh,
    sharded along `dim` over `axis`: each rank keeps its block, nothing
    is sent."""
    return DTensor.from_local(local_block(mesh, u, axis, dim), mesh,
                              _placements(mesh, axis, dim), run_check=False,
                              shape=u.shape, stride=u.stride())


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> DTensor:
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _staged(group, device: torch.device) -> bool:
    return device.type == "cuda" and "nccl" not in dist.get_backend(group)


def transport(mesh: DeviceMesh, axis: str = "space") -> str:
    """How tensors of the mesh's device cross between the ranks of
    `axis`."""
    group = mesh.get_group(axis)
    backend = dist.get_backend(group)
    if _staged(group, torch.device(mesh.device_type)):
        return f"host-staged (pinned buffers, {backend})"
    return f"direct ({backend}, {mesh.device_type} tensors)"


_pinned = {}


def to_host(t: torch.Tensor, tag: str) -> torch.Tensor:
    """A CUDA tensor copied into a pinned host buffer kept per (tag, shape,
    dtype); the copy is synchronous, so the buffer is free again when the
    next exchange of that tag starts."""
    key = (tag, tuple(t.shape), t.dtype)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
    buf.copy_(t)
    return buf


def host_buffer(shape, dtype, tag: str) -> torch.Tensor:
    key = (tag, tuple(shape), dtype)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return buf


def all_reduce(t: torch.Tensor, op: str = "sum", mesh: DeviceMesh = None,
               axis: str = "space") -> torch.Tensor:
    """t summed ("sum") or maxed ("max") over the ranks of `axis`, as a
    new tensor on t's device (the counterpart of `lax.psum` / `pmax`)."""
    mesh = mesh or current_mesh()
    group = mesh.get_group(axis)
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if _staged(group, t.device):
        buf = t.detach().cpu()
        dist.all_reduce(buf, rop, group=group)
        return buf.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, rop, group=group)
    return out


def gather_blocks(t: torch.Tensor, mesh: DeviceMesh = None,
                  axis: str = "space", dim: int = 0) -> torch.Tensor:
    """The global tensor from each rank's block `t` along `dim` (blocks
    of equal shape), on t's device on every rank."""
    mesh = mesh or current_mesh()
    group = mesh.get_group(axis)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    src = t.detach().contiguous()
    if _staged(group, t.device):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def full_state(x, mesh: DeviceMesh = None, axis: str = "space",
               dim: int = 0) -> torch.Tensor:
    """A DTensor sharded along `dim` over `axis` (or a rank's block) as
    the whole tensor on every rank, through `gather_blocks`."""
    local = x.to_local() if isinstance(x, DTensor) else x
    return gather_blocks(local, mesh, axis, dim)


class _Reducer:
    """`core/state.py`'s cross-rank reducer over the ranks of `axis`."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.mesh, self.axis = mesh, axis

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return all_reduce(t, op, mesh=self.mesh, axis=self.axis)

    def span(self, n: int):
        """(offset, total) of this rank's n entries in the blocks of the
        ranks of `axis` in their order (one all_gather)."""
        me = axis_info(self.mesh, self.axis)[0]
        sizes = gather_blocks(torch.tensor([n], dtype=torch.int64),
                              self.mesh, self.axis).tolist()
        return sum(sizes[:me]), sum(sizes)


_current = []


def current_mesh() -> DeviceMesh:
    if not _current:
        raise RuntimeError("no mesh in use: call inside "
                           "`with parallel.use_mesh(mesh):` or pass mesh=")
    return _current[-1][0]


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh, axis: str = "space"):
    """Run the solver stack on this rank's block of a state partitioned
    over `axis`: every reduction over the state (`core/state.py`'s dots,
    norms and sizes, the Krylov solvers' projections) is completed by an
    `all_reduce` over the ranks of `axis` (the JAX package's `with mesh:`
    under which XLA inserts the `psum`s)."""
    prev = _state.set_reducer(_Reducer(mesh, axis))
    _current.append((mesh, axis))
    try:
        yield mesh
    finally:
        _current.pop()
        _state.set_reducer(prev)
