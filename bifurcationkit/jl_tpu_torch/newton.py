"""Newton–Krylov solver — the port of `jl_tpu/newton.py` (ref src/Newton.jl).

The JAX package runs the whole iteration inside one `lax.while_loop`; here
it is a Python loop whose convergence test reads the residual norm on the
host once per iteration.  The jacobian realization is chosen from the
linear solver: direct solvers get a dense matrix (`jacfwd`), iterative
solvers the matrix-free operator (the model's `jac_op` when it has one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from . import check_tf32_off
from .core.params import NewtonPar
from .core.problem import BifurcationProblem
from .core.state import tree_axpy, tree_norm, tree_sub
from .linalg.linear import DenseLS


@dataclasses.dataclass
class NonLinearSolution:
    """Result of a nonlinear solve (ref `NonLinearSolution`, src/Newton.jl:49)."""

    u: Any
    prob: Any
    residuals: Any          # (max_iterations+1,) numpy array, NaN-padded
    converged: bool
    itnewton: int
    itlineartot: int

    @property
    def x(self):
        return self.u


def _pick_jacobian(prob: BifurcationProblem, options: NewtonPar):
    """Jacobian realization from the linear solver."""
    ls = options.linsolver
    if isinstance(ls, DenseLS) or getattr(ls, "needs_matrix", False):
        return prob.jacobian
    return prob.jacobian_operator


def default_callback(state_dict, **kwargs):
    return True


def cb_max_norm(max_norm: float):
    """Callback rejecting iterates with residual norm > max_norm
    (ref `cbMaxNorm`, src/Newton.jl:156-164)."""

    def cb(d, **kwargs):
        return d["residual_norm"] < max_norm

    return cb


def cb_max_norm_and_dp(max_norm: float, max_dp: float, p_ref: float):
    """Reject iterates with large residual OR parameter excursion
    (ref `cbMaxNormAndDp`, src/Newton.jl:166-179); for the PALC corrector,
    closing over the step's reference parameter."""

    def cb(d, **kwargs):
        ok = d["residual_norm"] < max_norm
        if "p" in d:
            ok = ok and abs(float(d["p"]) - p_ref) < max_dp
        return ok

    return cb


def newton(prob: BifurcationProblem,
           options: Optional[NewtonPar] = None,
           x0=None,
           params=None,
           callback: Callable = default_callback,
           norm: Callable = tree_norm) -> NonLinearSolution:
    """Solve F(u, params) = 0 by Newton's method
    (ref `solve(prob, ::Newton, options)`, src/Newton.jl:66-147), with the
    optional Armijo halving line search."""
    check_tf32_off()
    options = options or NewtonPar()
    x = prob.u0 if x0 is None else x0
    params = prob.params if params is None else params
    jac = _pick_jacobian(prob, options)
    ls = options.linsolver
    tol, max_it = options.tol, options.max_iterations

    res_f = prob.residual(x, params)
    res = float(norm(res_f))
    hist = np.full((max_it + 1,), np.nan)
    hist[0] = res
    keep = bool(callback({"x": x, "residual": res_f, "residual_norm": res,
                          "step": 0}))
    step, itlin = 0, 0
    while res > tol and step < max_it and keep:
        du, _, it_lin = ls(jac(x, params), res_f)
        x_new = tree_sub(x, du)
        res_f_new = prob.residual(x_new, params)
        res_new = float(norm(res_f_new))
        if options.linesearch:
            # halve the damping until the residual decreases (ref the
            # linesearch branch of src/continuation/Palc.jl:256-280,
            # applied to plain Newton); keep the full step otherwise
            alpha, ok = options.alpha, False
            while not ok and alpha > options.alpha_min:
                x_try = tree_axpy(-alpha, du, x)
                rf_try = prob.residual(x_try, params)
                r_try = float(norm(rf_try))
                if r_try < res:
                    x_new, res_f_new, res_new, ok = x_try, rf_try, r_try, True
                alpha *= 0.5
        x, res_f, res = x_new, res_f_new, res_new
        step += 1
        hist[step] = res
        itlin += int(it_lin)
        keep = bool(callback({"x": x, "residual": res_f,
                              "residual_norm": res, "step": step}))
    return NonLinearSolution(u=x, prob=prob, residuals=hist,
                             converged=res <= tol, itnewton=step,
                             itlineartot=itlin)
