"""State algebra — the port of `jl_tpu/core/state.py` (ref
src/BorderedArrays.jl:23-238).

A state is a tensor, a `BorderedState(u, p)`, or a dict / tuple / list of
those ("pytree" in the JAX package).  Every verb below maps over the
leaves; reductions return 0-d tensors on the state's device, so a caller
decides where the host needs a value (each `float(...)` of a CUDA tensor
is a device sync).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

Pytree = Any


@dataclasses.dataclass
class BorderedState:
    """Composite state `(u, p)` used by PALC and augmented problems: `u` a
    state (tensor or pytree), `p` a 0-d tensor (or small 1-d tensor)."""

    u: Pytree
    p: Any


# ---------------------------------------------------------------------------
# Leaf mapping over the supported containers
# ---------------------------------------------------------------------------


def tree_leaves(a: Pytree) -> list:
    if isinstance(a, BorderedState):
        return tree_leaves(a.u) + tree_leaves(a.p)
    if isinstance(a, dict):
        return [leaf for k in a for leaf in tree_leaves(a[k])]
    if isinstance(a, (tuple, list)):
        return [leaf for x in a for leaf in tree_leaves(x)]
    return [a]


def tree_map(fn, a: Pytree, *rest: Pytree) -> Pytree:
    if isinstance(a, BorderedState):
        return BorderedState(u=tree_map(fn, a.u, *[r.u for r in rest]),
                             p=tree_map(fn, a.p, *[r.p for r in rest]))
    if isinstance(a, dict):
        return {k: tree_map(fn, a[k], *[r[k] for r in rest]) for k in a}
    if isinstance(a, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(a, *rest)]
        return type(a)(out)
    return fn(a, *rest)


# ---------------------------------------------------------------------------
# Generic verbs (ref VectorInterface verbs, src/BorderedArrays.jl:86-217)
# ---------------------------------------------------------------------------


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Pytree, s) -> Pytree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: Pytree, y: Pytree) -> Pytree:
    """y + alpha * x (ref `VI.add!!(y, x, alpha)`)."""
    return tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def tree_axpby(alpha, x: Pytree, beta, y: Pytree) -> Pytree:
    return tree_map(lambda xi, yi: alpha * xi + beta * yi, x, y)


def tree_zeros_like(a: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, a)


def tree_vdot(a: Pytree, b: Pytree):
    """Conjugated dot product sum_i conj(a_i) b_i (ref `VI.inner`)."""
    parts = [torch.sum(torch.conj(x) * y)
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return sum(parts[1:], parts[0])


def tree_norm(a: Pytree):
    """L2 norm over all leaves."""
    return torch.sqrt(torch.real(tree_vdot(a, a)))


def tree_size(a: Pytree) -> int:
    """Total number of scalar entries (python int)."""
    return sum(int(torch.as_tensor(leaf).numel()) for leaf in tree_leaves(a))


# ---------------------------------------------------------------------------
# Flattening helper for dense linear algebra
# ---------------------------------------------------------------------------


def ravel(a: Pytree):
    """Flatten a state to a 1-D tensor; returns (flat, unravel_fn)."""
    if isinstance(a, torch.Tensor):
        shape = a.shape
        return a.reshape(-1), lambda f: f.reshape(shape)
    leaves = [torch.as_tensor(x) for x in tree_leaves(a)]
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])

    def unravel(f):
        parts = iter(torch.split(f, sizes))
        rebuilt = [next(parts).reshape(s) for s in shapes]
        it = iter(rebuilt)
        return tree_map(lambda _: next(it), a)

    return flat, unravel


# ---------------------------------------------------------------------------
# DotTheta — the weighted PALC dot product (ref src/continuation/Palc.jl:23-41)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DotTheta:
    """Weighted dot `<(u1,p1),(u2,p2)>_theta = theta*Re<u1,u2>/N + (1-theta)*p1*p2`
    with the reference's 1/N normalisation (ref `NormalisedDot`,
    src/continuation/Palc.jl:1-5)."""

    normalize: bool = True

    def dot(self, u1, u2, n: int):
        d = torch.real(tree_vdot(u1, u2))
        return d / n if self.normalize else d

    def dot_theta(self, u1, u2, p1, p2, theta, n: int):
        return self.dot(u1, u2, n) * theta + torch.real(
            torch.as_tensor(p1 * p2)) * (1.0 - theta)

    def norm_theta(self, u, p, theta, n: int):
        return torch.sqrt(self.dot_theta(u, u, p, p, theta, n))

    def dot_bs(self, a: BorderedState, b: BorderedState, theta, n: int):
        return self.dot_theta(a.u, b.u, a.p, b.p, theta, n)

    def norm_bs(self, a: BorderedState, theta, n: int):
        return self.norm_theta(a.u, a.p, theta, n)


def tree_randn_like(gen: torch.Generator, a: Pytree) -> Pytree:
    """Random normal state with the structure, dtype and device of `a`
    (ref `_randn`), drawn from the explicit generator `gen` on the CPU and
    moved to each leaf's device, so a seeded draw is the same on the card
    and on the CPU."""
    def draw(leaf):
        leaf = torch.as_tensor(leaf)
        dt = leaf.dtype if (leaf.is_floating_point() or leaf.is_complex()) \
            else torch.float64
        return torch.randn(tuple(leaf.shape), generator=gen,
                           dtype=dt).to(leaf.device)

    return tree_map(draw, a)
