"""Continuation results (ref src/Results.jl) — the port's copy of
`jl_tpu/continuation/results.py`: `ContResult`, the `Branch` of automatic
branch switching and `merge_branches` for two-sided continuation.

`ContResult` is the host-side branch table: per-step scalar records (a
struct-of-arrays dict, the numpy analogue of the reference's StructArray,
ref src/Results.jl:74-114), saved eigen-elements, solution samples and
detected special points.  Device tensors are pulled to the host once per step — only
the small record, never the full state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..detection.points import SpecialPoint


@dataclasses.dataclass
class ContResult:
    eig: List[dict] = dataclasses.field(default_factory=list)
    sol: List[dict] = dataclasses.field(default_factory=list)
    specialpoint: List[SpecialPoint] = dataclasses.field(default_factory=list)
    alg: Any = None
    prob: Any = None
    contparams: Any = None
    kind: str = "EquilibriumCont"

    # internal accumulation
    _records: List[dict] = dataclasses.field(default_factory=list)
    _branch_cache: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    # --- recording -------------------------------------------------------
    def append(self, record: dict):
        self._records.append(record)
        # keep the dict-of-arrays view fresh & cheap (rebuild lazily)
        self._branch_cache = {}

    @property
    def branch(self) -> Dict[str, np.ndarray]:
        """Struct-of-arrays branch table (the reference's StructArray view,
        ref src/Results.jl:74-114); built lazily from the records."""
        return self._table()

    def _table(self) -> Dict[str, np.ndarray]:
        if not self._branch_cache and self._records:
            keys = self._records[0].keys()
            self._branch_cache = {
                k: np.asarray([r[k] for r in self._records]) for k in keys}
        return self._branch_cache

    # --- accessors (ref src/Results.jl getters) --------------------------
    def __len__(self):
        return len(self._records)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._table()[key]
        if isinstance(key, int):
            return self._records[key]
        raise KeyError(key)

    @property
    def param(self) -> np.ndarray:
        return self._table()["param"]

    @property
    def stable(self) -> np.ndarray:
        return self._table().get("stable", np.ones(len(self), bool))

    @property
    def n_unstable(self) -> np.ndarray:
        return self._table().get("n_unstable", np.zeros(len(self), int))

    def get_solx(self, i: int):
        """Solution of the i-th *saved* solution (ref `get_solx`)."""
        return self.sol[i]["x"]

    def get_solp(self, i: int):
        return self.sol[i]["p"]

    def solution_at_step(self, step: int):
        for s in self.sol:
            if s["step"] == step:
                return s
        raise KeyError(f"no saved solution at step {step}")

    def eigenvals(self, i: int):
        """Eigenvalues stored for branch row i (ref `eigenvals(br, i)`)."""
        for e in self.eig:
            if e["step"] == self._records[i]["step"]:
                return e["eigenvals"]
        raise KeyError(f"no eigen-elements at branch row {i}")

    def eigenvec(self, i: int, which: int):
        for e in self.eig:
            if e["step"] == self._records[i]["step"]:
                if e.get("eigenvecs") is None:
                    raise ValueError("eigenvectors were not saved; set "
                                     "save_eigenvectors=True")
                return e["eigenvecs"][:, which]
        raise KeyError(f"no eigen-elements at branch row {i}")

    # --- special points --------------------------------------------------
    def n_special_points(self) -> int:
        return len(self.specialpoint)

    def get_special_points(self, tp: str) -> List[SpecialPoint]:
        return [sp for sp in self.specialpoint if sp.type == tp]

    def show(self):
        print(self.__repr__())

    def __repr__(self):
        lines = [f"ContResult[{self.kind}] with {len(self)} points"
                 f" (param in [{self.param.min():.6g}, {self.param.max():.6g}])"
                 if len(self) else "ContResult (empty)"]
        for i, sp in enumerate(self.specialpoint):
            lines.append(f"  - #{i:2d} {sp.type:>6s} at param = "
                         f"{sp.param: .8f} ∈ ({sp.interval[0]:.8f}, "
                         f"{sp.interval[1]:.8f}), step = {sp.step}, "
                         f"status = {sp.status}")
        return "\n".join(lines)


@dataclasses.dataclass
class Branch:
    """A branch obtained from automatic branch switching: a ContResult plus
    the special point it bifurcated from (ref `Branch`, src/Results.jl:354)."""

    gamma: ContResult = None
    bp: Any = None

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "gamma"), name)

    def __len__(self):
        return len(self.gamma)

    def __getitem__(self, key):
        return self.gamma[key]


def merge_branches(fw: ContResult, bw: ContResult) -> ContResult:
    """Merge forward & backward runs for `bothside=True`
    (ref `_merge`, src/Results.jl:398-498): the backward branch is reversed
    and prepended; step indices are relabelled monotonically."""
    out = ContResult(alg=fw.alg, prob=fw.prob, contparams=fw.contparams,
                     kind=fw.kind)
    nbw = len(bw)
    # reversed backward part (drop its first record: duplicate of start point)
    recs = list(reversed(bw._records))[:-1] + list(fw._records)
    for i, r in enumerate(recs):
        r = dict(r)
        r["step"] = i
        out._records.append(r)

    def relabel(step, from_bw):
        if from_bw:
            return nbw - 1 - step if (nbw - 1 - step) >= 0 else 0
        return nbw - 1 + step

    for e in bw.eig:
        if relabel(e["step"], True) < nbw - 1:
            out.eig.append({**e, "step": relabel(e["step"], True)})
    for e in fw.eig:
        out.eig.append({**e, "step": relabel(e["step"], False)})
    for s in bw.sol:
        if relabel(s["step"], True) < nbw - 1:
            out.sol.append({**s, "step": relabel(s["step"], True)})
    for s in fw.sol:
        out.sol.append({**s, "step": relabel(s["step"], False)})
    for sp in bw.specialpoint:
        if sp.type == "endpoint":
            continue
        sp2 = dataclasses.replace(sp)
        sp2.step = relabel(sp.step, True)
        sp2.idx = relabel(sp.idx, True)
        out.specialpoint.append(sp2)
    for sp in fw.specialpoint:
        sp2 = dataclasses.replace(sp)
        sp2.step = relabel(sp.step, False)
        sp2.idx = relabel(sp.idx, False)
        out.specialpoint.append(sp2)
    out.specialpoint.sort(key=lambda s: s.step)
    return out
