"""Tangent predictors (ref src/continuation/Tangents.jl) — config classes;
the kernels live in `kernels.py`."""
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
