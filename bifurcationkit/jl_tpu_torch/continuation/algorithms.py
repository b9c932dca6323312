"""Continuation algorithm configurations — the port of
`jl_tpu/continuation/algorithms.py` for the algorithms this slice runs:

* `PALC`    — pseudo-arclength (ref src/continuation/Palc.jl:70-84)
* `Natural` — parameter stepping (ref src/continuation/Natural.jl)

Static config; the per-step numeric kernels are built from them in
`kernels.py` / `engine.py`.
"""
from __future__ import annotations

import dataclasses
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
