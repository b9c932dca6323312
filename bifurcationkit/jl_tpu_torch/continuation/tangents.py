"""Tangent predictors (ref src/continuation/Tangents.jl) — config classes;
the kernels live in `kernels.py` (Secant, Bordered) and `engine.py`
(Polynomial)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Secant:
    """tau = (z1 - z0) * sign(ds) / ||z1 - z0||_theta
    (ref src/continuation/Tangents.jl:28-54)."""


@dataclasses.dataclass(frozen=True)
class Bordered:
    """Tangent from the bordered system [J dFdp; theta/N tau_u (1-theta) tau_p]
    [tau] = [0; 1], normalized to ||tau||_theta = 1 with orientation preserved
    (ref src/continuation/Tangents.jl:71-104)."""


@dataclasses.dataclass(frozen=True)
class Polynomial:
    """Least-squares polynomial extrapolation over the last k points in
    arclength (ref src/continuation/Tangents.jl:126-233).  Falls back to
    `tangent` until k points are accumulated."""

    n: int = 2          # polynomial order
    k: int = 6          # number of retained solutions (k > n)
    tangent: object = dataclasses.field(default_factory=Secant)

    def __post_init__(self):
        assert self.k > self.n, "need more points than polynomial order"
