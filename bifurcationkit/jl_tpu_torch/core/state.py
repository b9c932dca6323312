"""State algebra — the port of `jl_tpu/core/state.py` (ref
src/BorderedArrays.jl:23-238).

A state is a tensor, a `BorderedState(u, p)`, or a dict / tuple / list of
those ("pytree" in the JAX package).  Every verb below maps over the
leaves; reductions return 0-d tensors on the state's device, so a caller
decides where the host needs a value (each `float(...)` of a CUDA tensor
is a device sync).

Row-partitioned states (`parallel/`): inside `parallel.use_mesh(mesh)`
each rank holds its block of the state, and every reduction over the
state (the dots, norms and sizes below, and the Krylov solvers'
projections through `allreduce`) is summed over the mesh's `space` ranks.
Outside it the reducer is None and each reduction is the plain
single-device one, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

Pytree = Any

# The cross-rank reducer of a row-partitioned state, None on one device
# (installed by `parallel.use_mesh`): `reduce(t, op)` completes a sum
# ("sum") or max ("max") over this rank's block over the ranks, and
# `span(n)` gives (offset, total) of this rank's n entries in the ranks'
# concatenated blocks.
_REDUCER = None


def set_reducer(reducer):
    """Install the cross-rank reducer (or None); returns the previous one."""
    global _REDUCER
    prev, _REDUCER = _REDUCER, reducer
    return prev


def allreduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`t`, a reduction over this rank's block, completed over the ranks
    (the identity on one device)."""
    return t if _REDUCER is None else _REDUCER.reduce(t, op)


def check_partition(partitioned: bool, what: str) -> None:
    """Raise unless the cross-rank reducer is installed exactly when `what`
    runs on a row-partitioned state: code that completes its reductions
    over the ranks must run inside `parallel.use_mesh`, and code that does
    not (the dense solvers, LOBPCG, block GMRES, ...) outside it, where it
    would otherwise return one rank's partial answer."""
    if (_REDUCER is not None) == partitioned:
        return
    if partitioned:
        raise RuntimeError(f"{what} runs on one rank's block of a "
                           "row-partitioned state: call it inside "
                           "`parallel.use_mesh(mesh)`")
    raise NotImplementedError(f"{what} does not reduce over the ranks of a "
                              "row-partitioned state: call it outside "
                              "`parallel.use_mesh`")


def global_size(n: int, n_rep: int = 0) -> int:
    """A flat block's number of entries summed over the ranks; its last
    `n_rep` entries (a bordered state's `p`) are the same on every rank
    and count once."""
    if _REDUCER is None:
        return n
    return _REDUCER.span(n - n_rep)[1] + n_rep


def global_dot(V: torch.Tensor, w: torch.Tensor,
               n_rep: int = 0) -> torch.Tensor:
    """`V @ w` over the ranks' flat blocks (`V` one vector or a stack of
    rows); the last `n_rep` entries are the same on every rank and count
    once.  The plain product on one device."""
    if _REDUCER is None:
        return V @ w
    if n_rep == 0:
        return _REDUCER.reduce(V @ w, "sum")
    k = w.shape[0] - n_rep
    return _REDUCER.reduce(V[..., :k] @ w[:k], "sum") + V[..., k:] @ w[k:]


def global_norm(x: torch.Tensor, n_rep: int = 0) -> torch.Tensor:
    """The 2-norm of a flat block over all ranks, its last `n_rep`
    entries counted once (`torch.linalg.vector_norm` on one device)."""
    if _REDUCER is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(global_dot(x, x, n_rep))


def global_bdot(V: torch.Tensor, W: torch.Tensor,
                n_rep: int = 0) -> torch.Tensor:
    """The batched projections `V[c] @ W[c]` ((k, j, n) and (k, n) in,
    (k, j) out) over the ranks' flat blocks, the last `n_rep` entries of
    each row counted once; `torch.bmm` on one device."""
    def bdot(a, b):
        return torch.bmm(a, b[:, :, None])[:, :, 0]

    if _REDUCER is None:
        return bdot(V, W)
    if n_rep == 0:
        return _REDUCER.reduce(bdot(V, W), "sum")
    k = W.shape[1] - n_rep
    return (_REDUCER.reduce(bdot(V[..., :k], W[:, :k]), "sum")
            + bdot(V[..., k:], W[:, k:]))


def global_row_norms(W: torch.Tensor, n_rep: int = 0) -> torch.Tensor:
    """The 2-norm of each row of a (k, n) stack of flat blocks over all
    ranks, the last `n_rep` entries of each counted once
    (`torch.linalg.vector_norm(W, dim=1)` on one device)."""
    if _REDUCER is None:
        return torch.linalg.vector_norm(W, dim=1)
    return torch.sqrt(global_bdot(W[:, None, :], W, n_rep)[:, 0])


def local_randn(gen: torch.Generator, n: int, dtype, device) -> torch.Tensor:
    """n normal draws from `gen`; with a reducer, this rank's slice of one
    draw over all ranks' entries, so the ranks start from the vector one
    device would draw (in the ranks' order of the entries)."""
    if _REDUCER is None:
        return torch.randn((n,), generator=gen, dtype=dtype, device=device)
    off, total = _REDUCER.span(n)
    return torch.randn((total,), generator=gen, dtype=dtype,
                       device=device)[off:off + n]


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


def tree_conj(a: Pytree) -> Pytree:
    return tree_map(torch.conj, a)


def tree_real(a: Pytree) -> Pytree:
    return tree_map(torch.real, a)


def _reduced(part, a: Pytree, *rest: Pytree, op: str = "sum"):
    """`part` over the leaves, completed over the ranks.  A
    `BorderedState`'s `p` is the same on every rank: only its `u` is
    reduced over them (the order of the sum is the leaves' either way)."""
    if isinstance(a, BorderedState):
        u = part(a.u, *[r.u for r in rest])
        p = part(a.p, *[r.p for r in rest])
        return (torch.maximum(allreduce(u, op), p) if op == "max"
                else allreduce(u, op) + p)
    return allreduce(part(a, *rest), op)


def _leaf_sum(fn):
    def part(*trees):
        parts = [fn(*xs) for xs in zip(*map(tree_leaves, trees))]
        return sum(parts[1:], parts[0])
    return part


def tree_dot(a: Pytree, b: Pytree):
    """Unconjugated dot product sum_i a_i b_i over all leaves."""
    return _reduced(_leaf_sum(lambda x, y: torch.sum(x * y)), a, b)


def tree_vdot(a: Pytree, b: Pytree):
    """Conjugated dot product sum_i conj(a_i) b_i (ref `VI.inner`)."""
    return _reduced(_leaf_sum(lambda x, y: torch.sum(torch.conj(x) * y)),
                    a, b)


def tree_norm(a: Pytree):
    """L2 norm over all leaves."""
    return torch.sqrt(torch.real(tree_vdot(a, a)))


def _leaf_max(t: Pytree):
    parts = [torch.max(torch.abs(torch.as_tensor(x))) for x in tree_leaves(t)]
    out = parts[0]
    for x in parts[1:]:
        out = torch.maximum(out, x)
    return out


def tree_norm_inf(a: Pytree):
    """Max-norm over all leaves."""
    return _reduced(_leaf_max, a, op="max")


def _numel(t: Pytree) -> int:
    return sum(int(torch.as_tensor(leaf).numel()) for leaf in tree_leaves(t))


def tree_size(a: Pytree) -> int:
    """Total number of scalar entries (python int)."""
    if isinstance(a, BorderedState):
        return global_size(_numel(a.u)) + _numel(a.p)
    return global_size(_numel(a))


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


def arc_length_eq(dot_t: DotTheta, u, p, du, dp, theta, ds, n: int):
    """PALC constraint N(x, p) (ref src/continuation/Palc.jl:44)."""
    return dot_t.dot_theta(u, du, p, dp, theta, n) - ds


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
