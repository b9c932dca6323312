"""Mesh-partitionable PDE operators — the port of `jl_tpu/parallel/ops.py`.

Stencil applications written with `torch.roll`, plain functions of a
tensor.  They also take a DTensor sharded along either axis, on which
DTensor lowers the wrap-around neighbours to its own collectives; the
solver stack's sharded path uses the explicit halo exchange of `halo.py`
instead.
"""
from __future__ import annotations

import torch

from ..periodic.floquet import monodromy_from_maps
from .mesh import gather_blocks


def periodic_laplacian_2d(u: torch.Tensor, hx: float, hy: float):
    """5-point periodic Laplacian; partitions along either axis."""
    return ((torch.roll(u, 1, 0) - 2 * u + torch.roll(u, -1, 0)) / hx ** 2
            + (torch.roll(u, 1, 1) - 2 * u + torch.roll(u, -1, 1)) / hy ** 2)


def sh_operator_2d(u: torch.Tensor, hx: float, hy: float):
    """Swift-Hohenberg linear operator -(I + Delta)^2 u
    (ref examples/SH2d-fronts.jl:8-32 builds the same bilaplacian operator
    as a sparse matrix; here it is a fused 13-point stencil)."""
    v = u + periodic_laplacian_2d(u, hx, hy)
    return -(v + periodic_laplacian_2d(v, hx, hy))


def sh_residual_2d(u, params, hx, hy):
    """Swift-Hohenberg 2D residual: -(I+Delta)^2 u + l*u + nu*u^2 - u^3
    (ref examples/SH2d-fronts.jl:35-42)."""
    l = params["l"]
    nu = params["nu"]
    return sh_operator_2d(u, hx, hy) + l * u + nu * u * u - u * u * u


def sharded_monodromy(maps: torch.Tensor, mesh=None, axis: str = "space"):
    """Time-sharded monodromy product: each rank holds a slice of the
    per-interval fundamental maps (in time order over the ranks of
    `axis`) and multiplies it (`monodromy_from_maps`, pairwise tree); the
    ranks' blocks are then gathered and combined in a tree, the product
    M_{Ntst-1} @ ... @ M_0 on every rank (the JAX package's associative
    scan over maps sharded on the mesh's time axis)."""
    block = monodromy_from_maps(maps, method="assoc")
    blocks = gather_blocks(block[None], mesh, axis, dim=0)
    return monodromy_from_maps(blocks, method="assoc")
