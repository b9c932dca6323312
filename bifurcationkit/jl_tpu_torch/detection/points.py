"""Special (bifurcation) point records (ref src/BifurcationPoints.jl) —
the port's own copy of `SpecialPoint` from `jl_tpu/detection/points.py`,
the generic branch annotation (ref :22-93).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SpecialPoint:
    """A detected point along a branch (ref src/BifurcationPoints.jl:22-93).

    type: one of 'bp', 'fold', 'hopf', 'nd', 'pd', 'ns', 'user', 'endpoint',
          'bt', 'cusp', 'zh', 'gh', 'hh', ...
    status: 'guess' | 'converged' | 'guessL'
    """

    type: str = "none"
    idx: int = 0                  # row index into the branch table
    param: float = 0.0
    norm: float = 0.0
    printsol: Any = None          # record_from_solution at the point
    x: Any = None                 # solution (just after the point)
    tau: Any = None               # tangent BorderedState
    ind_ev: int = 0               # index of bifurcating eigenvalue
    step: int = 0
    status: str = "guess"
    delta: Tuple[int, int] = (0, 0)   # (δn_unstable, δn_imag)
    precision: float = -1.0
    interval: Tuple[float, float] = (0.0, 0.0)
    eigenvals: Optional[np.ndarray] = None
    eigenvecs: Optional[Any] = None

    def __repr__(self):
        return (f"SpecialPoint(type={self.type!r}, param={self.param:.8g}, "
                f"step={self.step}, status={self.status!r}, "
                f"interval=({self.interval[0]:.8g}, {self.interval[1]:.8g}), "
                f"delta={self.delta})")


def kernel_dimension(sp: SpecialPoint) -> int:
    """Dimension of the kernel of the jacobian at the point
    (ref src/BifurcationPoints.jl:101)."""
    return abs(sp.delta[0])
