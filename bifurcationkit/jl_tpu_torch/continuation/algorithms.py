"""Continuation algorithm configurations — the port of
`jl_tpu/continuation/algorithms.py`:

* `PALC`         — pseudo-arclength (ref src/continuation/Palc.jl:70-84)
* `Natural`      — parameter stepping (ref src/continuation/Natural.jl)
* `MoorePenrose` — pseudo-inverse corrector (ref src/continuation/MoorePenrose.jl:23)
* `Multiple`     — pmcont multi-predictor (ref src/continuation/Multiple.jl:17)
* `AutoSwitch`   — Natural <-> PALC switching (ref src/continuation/AutoSwitch.jl:15)

Static config; the per-step numeric kernels are built from them in
`kernels.py` / `engine.py`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

from .tangents import Secant


@dataclasses.dataclass(frozen=True)
class PALC:
    tangent: Any = dataclasses.field(default_factory=Secant)
    theta: float = 0.5
    bls: Any = None      # bordered linear solver; default chosen in kernels

    def __post_init__(self):
        assert 0 <= self.theta <= 1, "theta must be in [0, 1]"


@dataclasses.dataclass(frozen=True)
class Natural:
    """Continuation in the parameter itself; cannot pass folds
    (ref src/continuation/Natural.jl)."""


class MoorePenroseLS(enum.Enum):
    direct = 0
    pInv = 1
    iterative = 2


@dataclasses.dataclass(frozen=True)
class MoorePenrose:
    """Moore-Penrose / Gauss-Newton continuation
    (ref src/continuation/MoorePenrose.jl:23-127)."""

    tangent: Any = dataclasses.field(default_factory=Secant)
    method: MoorePenroseLS = MoorePenroseLS.direct
    ls: Any = None

    @property
    def theta(self):
        return 0.5


@dataclasses.dataclass(frozen=True)
class Multiple:
    """pde2path's pmcont: nb predictors at distances ds*pmimax..,
    accepted when the newton residual decays by `alpha` per iteration
    (ref src/continuation/Multiple.jl:17-67)."""

    alg: PALC = dataclasses.field(default_factory=PALC)
    alpha: float = 0.9
    nb: int = 4
    dsfact: float = 0.5

    @property
    def tangent(self):
        return self.alg.tangent

    @property
    def theta(self):
        return self.alg.theta

    @property
    def bls(self):
        return self.alg.bls


@dataclasses.dataclass(frozen=True)
class AutoSwitch:
    """Switch between Natural (shallow branch) and PALC (steep branch)
    based on (1-theta)*|tau_p| vs tol_param
    (ref src/continuation/AutoSwitch.jl:15-74)."""

    alg: PALC = dataclasses.field(default_factory=PALC)
    tol_param: float = 0.5

    @property
    def tangent(self):
        return self.alg.tangent

    @property
    def theta(self):
        return self.alg.theta

    @property
    def bls(self):
        return self.alg.bls
