"""Deflation operators and deflated Newton — the port of
`jl_tpu/deflation.py` (ref src/DeflationOperator.jl).

`DeflationOperator` penalizes known roots so Newton finds new solutions:
M(u) = prod_i (1 / ||u - root_i||^(2p) + alpha), and the deflated problem
is G(u) = M(u) F(u) (ref :57-88,180).  The root set lives in a
fixed-capacity stacked tensor (`max_roots`, n) with an active count, as
in the JAX package; the jacobian of G comes from `torch.func` straight
through M, which subsumes the reference's Sherman-Morrison solver
(`DeflatedProblemCustomLS`, :265).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from .core.lens import Lens, as_lens
from .core.params import NewtonPar
from .core.problem import BifurcationProblem
from .core.state import ravel, tree_map, tree_norm
from .newton import NonLinearSolution, newton


@dataclasses.dataclass
class DeflationOperator:
    """M(u) = prod_i (1/||u - root_i||^(2p) + alpha)
    (ref DeflationOperator, src/DeflationOperator.jl:57-88)."""

    power: float = 2.0
    alpha: float = 1.0
    roots: List[Any] = dataclasses.field(default_factory=list)
    max_roots: int = 16

    def __len__(self):
        return len(self.roots)

    def push(self, root):
        if len(self.roots) >= self.max_roots:
            raise RuntimeError(f"deflation capacity {self.max_roots} reached;"
                               " raise max_roots")
        self.roots.append(root)

    def clear(self):
        self.roots = []

    def packed_roots(self, like):
        """The roots stacked into a fixed (max_roots, n) tensor (zero
        padded) and their count."""
        flat0, _ = ravel(like)
        arr = torch.zeros((self.max_roots, flat0.shape[0]),
                          dtype=flat0.dtype, device=flat0.device)
        for i, r in enumerate(self.roots):
            arr[i] = ravel(r)[0]
        return arr, len(self.roots)

    def M(self, u):
        """The deflation factor at u."""
        arr, k = self.packed_roots(u)
        return _deflation_factor(u, arr, k, self.power, self.alpha)


def _deflation_factor(u, roots_arr, k, power, alpha):
    flat, _ = ravel(u)
    d2 = torch.sum((roots_arr[:k] - flat[None, :]) ** 2, dim=1)
    return torch.prod(1.0 / torch.clamp_min(d2, 1e-300) ** power + alpha)


def deflated_problem(prob: BifurcationProblem,
                     defl: DeflationOperator) -> BifurcationProblem:
    """G(u, par) = M(u) F(u) as a standard `BifurcationProblem` whose
    params carry the root set (ref DeflatedProblem,
    src/DeflationOperator.jl:180)."""
    power, alpha = defl.power, defl.alpha

    def G(u, par):
        m = _deflation_factor(u, par["_defl_roots"], par["_defl_k"],
                              power, alpha)
        return tree_map(lambda x: m * x, prob.F(u, par["_inner"]))

    roots_arr, k = defl.packed_roots(prob.u0)
    inner_lens = as_lens(prob.lens)
    lens = Lens(
        get=lambda par: inner_lens.get(par["_inner"]),
        set=lambda par, v: {**par, "_inner": inner_lens.set(par["_inner"],
                                                            v)},
        name=f"defl/{inner_lens.name}")
    return BifurcationProblem(
        G, u0=prob.u0,
        params={"_inner": prob.params, "_defl_roots": roots_arr,
                "_defl_k": k},
        lens=lens)


def deflated_newton(prob: BifurcationProblem, defl: DeflationOperator,
                    options: Optional[NewtonPar] = None, x0=None, params=None,
                    **kwargs) -> NonLinearSolution:
    """Newton on the deflated problem (ref solve(prob, defOp, options),
    src/DeflationOperator.jl:339-389).  `converged` also asks the original
    problem's residual at the solution to be below 10 tol."""
    options = options or NewtonPar()
    dprob = deflated_problem(prob, defl)
    params = prob.params if params is None else params
    roots_arr, k = defl.packed_roots(prob.u0)
    dparams = {"_inner": params, "_defl_roots": roots_arr, "_defl_k": k}
    sol = newton(dprob, options, x0=x0, params=dparams, **kwargs)
    res = float(tree_norm(prob.F(sol.u, params)))
    sol.converged = bool(sol.converged) and res < 10 * options.tol
    return sol
