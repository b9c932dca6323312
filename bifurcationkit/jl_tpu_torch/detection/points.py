"""Special (bifurcation) point records (ref src/BifurcationPoints.jl) —
the port's own copy of `jl_tpu/detection/points.py`.

`SpecialPoint` is the generic branch annotation (ref :22-93); the typed
bifurcation point classes carry normal-form data filled in by
`get_normal_form` (ref :155-320).
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


# ---------------------------------------------------------------------------
# Typed bifurcation points filled by normal-form computation
# (ref src/BifurcationPoints.jl:155-398)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BifPoint:
    """Base for normal-form-annotated points."""

    x0: Any = None          # solution at the point
    p: float = 0.0          # parameter value
    params: Any = None      # full parameter pytree at the point
    lens: Any = None
    zeta: Any = None        # right eigenvector(s) / kernel basis
    zeta_star: Any = None   # left eigenvector(s)
    nf: Any = None          # normal form coefficients
    type: str = "none"
    prob: Any = None


@dataclasses.dataclass
class BranchPoint(BifPoint):
    type: str = "bp"


@dataclasses.dataclass
class Pitchfork(BifPoint):
    type: str = "pitchfork"


@dataclasses.dataclass
class Transcritical(BifPoint):
    type: str = "transcritical"


@dataclasses.dataclass
class Fold(BifPoint):
    type: str = "fold"


@dataclasses.dataclass
class NdBranchPoint(BifPoint):
    type: str = "nd"


@dataclasses.dataclass
class Hopf(BifPoint):
    type: str = "hopf"
    omega: float = 0.0      # imaginary part of the eigenvalue


@dataclasses.dataclass
class PeriodDoubling(BifPoint):
    type: str = "pd"


@dataclasses.dataclass
class NeimarkSacker(BifPoint):
    type: str = "ns"
    omega: float = 0.0


# codim-2 points (ref src/BifurcationPoints.jl:254-398)
@dataclasses.dataclass
class Cusp(BifPoint):
    type: str = "cusp"


@dataclasses.dataclass
class BogdanovTakens(BifPoint):
    type: str = "bt"
    nfsupp: Any = None      # extra coefficients for predictors


@dataclasses.dataclass
class Bautin(BifPoint):
    type: str = "gh"
    omega: float = 0.0


@dataclasses.dataclass
class ZeroHopf(BifPoint):
    type: str = "zh"
    omega: float = 0.0


@dataclasses.dataclass
class HopfHopf(BifPoint):
    type: str = "hh"
    omega1: float = 0.0
    omega2: float = 0.0
