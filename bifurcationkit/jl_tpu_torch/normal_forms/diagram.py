"""Automatic bifurcation diagram computation
(ref src/bifdiagram/BifurcationDiagram.jl) — the port of
`jl_tpu/normal_forms/diagram.py`.

`bifurcationdiagram(prob, alg, level, options)` recursively continues every
branch emanating from every detected branch point, building a tree of
`BifDiagNode`s (ref BifDiagNode :17, bifurcationdiagram! :106-263)."""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, List, Optional

from ..continuation.algorithms import PALC
from ..continuation.driver import continuation
from .branch_switch import continuation_from_bp, multicontinuation


@dataclasses.dataclass
class BifDiagNode:
    level: int
    gamma: Any                      # ContResult / Branch
    children: List["BifDiagNode"] = dataclasses.field(default_factory=list)
    code: int = 0

    def __len__(self):
        return 1 + sum(len(c) for c in self.children)

    def get_branch(self, *code):
        """Navigate the tree by child indices (ref get_branch)."""
        node = self
        for c in code:
            node = node.children[c]
        return node

    def get_branches_from_BP(self, idx):
        return [c for c in self.children if c.code == idx]

    def show(self, indent=0):
        pad = "  " * indent
        n_sp = len([sp for sp in self.gamma.specialpoint
                    if sp.type not in ("endpoint",)])
        print(f"{pad}[level {self.level}] branch with {len(self.gamma)} "
              f"points, {n_sp} special points")
        for c in self.children:
            c.show(indent + 1)


def bifurcationdiagram(prob, alg=None, level: int = 2,
                       options: Optional[Callable] = None,
                       contparams=None,
                       **kwargs) -> BifDiagNode:
    """Compute the bifurcation diagram down to `level` levels of branching.

    `options(x, p, level) -> ContinuationPar` customizes per-level parameters
    (ref bifurcationdiagram, src/bifdiagram/BifurcationDiagram.jl:106)."""
    alg = alg or PALC()
    if options is None:
        assert contparams is not None, \
            "provide `contparams` or an `options(x, p, level)` callable"
        options = lambda x, p, lvl: contparams    # noqa: E731
    cp = options(prob.u0, prob.param_value, 1)
    br = continuation(prob, alg, cp, **kwargs)
    node = BifDiagNode(level=1, gamma=br)
    bifurcationdiagram_rec(prob, node, level, options, alg=alg, **kwargs)
    return node


def bifurcationdiagram_rec(prob, node: BifDiagNode, maxlevel: int,
                           options, alg=None, **kwargs):
    """Grow the tree below `node` (ref bifurcationdiagram!, :151-237)."""
    if node.level >= maxlevel:
        return node
    br = node.gamma
    for i, sp in enumerate(br.specialpoint):
        if sp.type not in ("bp", "nd"):
            continue
        cp = options(sp.x, sp.param, node.level + 1)
        try:
            if sp.type == "nd" or abs(sp.delta[0]) > 1:
                _, branches = multicontinuation(br, i, cp, alg, **kwargs)
            else:
                branches = [continuation_from_bp(br, i, cp, alg, **kwargs)]
        except (RuntimeError, ValueError) as e:
            warnings.warn(f"branch switching failed at special point {i} "
                          f"({sp.type} at p={sp.param:.6g}): {e}")
            continue
        for gamma in branches:
            child = BifDiagNode(level=node.level + 1, gamma=gamma, code=i)
            node.children.append(child)
            bifurcationdiagram_rec(prob, child, maxlevel, options, alg=alg,
                                   **kwargs)
    return node
