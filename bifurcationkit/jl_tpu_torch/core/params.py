"""Immutable solver / continuation configuration — the port of
`jl_tpu/core/params.py`: `NewtonPar` (ref src/Newton.jl:17-33) and
`ContinuationPar` (ref src/ContParameters.jl:44-100), same fields, defaults
and checks."""
from __future__ import annotations

import dataclasses
from typing import Any


def _default_ls():
    from ..linalg.linear import DenseLS

    return DenseLS()


def _default_eig():
    from ..linalg.eig import DenseEig

    return DenseEig()


@dataclasses.dataclass(frozen=True)
class NewtonPar:
    """Newton–Krylov options (ref src/Newton.jl:17-33)."""

    tol: float = 1e-12
    max_iterations: int = 25
    verbose: bool = False
    linsolver: Any = dataclasses.field(default_factory=_default_ls)
    eigsolver: Any = dataclasses.field(default_factory=_default_eig)
    linesearch: bool = False
    alpha: float = 1.0       # initial damping for the line search
    alpha_min: float = 1e-4  # minimal damping

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ContinuationPar:
    """Continuation options (ref src/ContParameters.jl:44-100)."""

    dsmin: float = 1e-4
    dsmax: float = 1e-1
    ds: float = 1e-2
    a: float = 0.5                 # step-size aggressiveness
    p_min: float = -1.0
    p_max: float = 1.0
    max_steps: int = 400
    newton_options: NewtonPar = dataclasses.field(default_factory=NewtonPar)
    eta: float = 150.0             # finite-difference scale for first tangent

    save_to_file: bool = False
    save_sol_every_step: int = 1

    nev: int = 3
    save_eig_every_step: int = 1
    save_eigenvectors: bool = True

    plot_every_step: int = 10

    tol_stability: float = 1e-10
    detect_fold: bool = True
    detect_bifurcation: int = 3    # 0..3 (3 = detect + bisection localize)
    dsmin_bisection: float = 1e-16
    n_inversion: int = 2
    max_bisection_steps: int = 25
    tol_bisection_eigenvalue: float = 1e-16

    detect_event: int = 0          # 0..2
    tol_param_bisection_event: float = 1e-16
    detect_loop: bool = False

    def __post_init__(self):
        assert self.tol_stability >= 0
        assert self.dsmax >= abs(self.ds) >= self.dsmin >= 0, (
            f"need dsmax >= |ds| >= dsmin >= 0, got {self.dsmax} >= "
            f"{abs(self.ds)} >= {self.dsmin}")
        assert abs(self.ds) >= self.dsmin_bisection >= 0
        assert self.p_max >= self.p_min
        assert self.n_inversion % 2 == 0, "n_inversion must be even"
        assert 0 <= self.detect_bifurcation <= 3
        assert 0 <= self.detect_event <= 2
        assert self.tol_bisection_eigenvalue >= 0

    # ref src/ContParameters.jl:102-106
    @property
    def compute_eigenelements(self) -> bool:
        return self.detect_bifurcation > 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def setfield(obj, **kw):
    """`set`-style functional update (the reference's `@set opts.ds = ...`)."""
    return dataclasses.replace(obj, **kw)
