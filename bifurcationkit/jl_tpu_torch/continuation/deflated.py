"""Deflated continuation — the port of `jl_tpu/continuation/deflated.py`
(ref src/DeflatedContinuation.jl).

Continues all known solution branches at once: each parameter step
advances every active branch with the other branches deflated, then
seeks new branches with deflated Newton from perturbed points (ref
`DefCont` :14, `updatebranch!` :100, `_deflated_continuation`
:211-354).  The random perturbations come from a `torch.Generator`
seeded with `DefCont.seed` (`tree_randn_like`); `perturb_solution`
replaces them with the caller's own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..core.params import ContinuationPar
from ..core.state import tree_axpy, tree_norm, tree_randn_like, tree_sub
from ..deflation import DeflationOperator, deflated_newton
from ..detection.points import SpecialPoint
from ..newton import newton
from .algorithms import PALC
from .engine import ContIterable
from .results import ContResult


@dataclasses.dataclass
class DefCont:
    """Deflated-continuation algorithm config (ref DefCont, :14-58)."""

    deflation_operator: DeflationOperator = None
    max_branches: int = 20
    seek_every_step: int = 1
    max_new_branches: int = 3
    perturb_factor: float = 0.015
    accept_solution: Optional[Callable] = None
    # custom start-point perturbation for the new-branch seek,
    # (sol, p, id) -> x0 (ref the perturb_solution kwarg, DefCont :14-58)
    perturb_solution: Optional[Callable] = None
    seed: int = 42


@dataclasses.dataclass
class DCResult:
    """Result of deflated continuation (ref DCResult, :60)."""

    prob: Any
    branches: List[ContResult]
    alg: Any = None

    def __len__(self):
        return len(self.branches)

    def __getitem__(self, i):
        return self.branches[i]


def deflated_continuation(prob, alg: DefCont, contparams: ContinuationPar,
                          verbosity: int = 0) -> DCResult:
    """ref _deflated_continuation, src/DeflatedContinuation.jl:211-354."""
    cp = contparams
    defl = alg.deflation_operator or DeflationOperator(
        max_roots=alg.max_branches + 4)
    if defl.max_roots < alg.max_branches:
        defl.max_roots = alg.max_branches + 4
    gen = torch.Generator().manual_seed(alg.seed)

    # the engine's kernels (eigensolves) serve every branch
    it = ContIterable(prob, PALC(), cp)
    p0 = float(prob.get_lens_param(prob.params))

    # --- initial roots: the given roots, or Newton from u0 ---------------
    if len(defl.roots) == 0:
        sol0 = newton(prob, cp.newton_options)
        if not sol0.converged:
            raise RuntimeError("deflated continuation: Newton failed on the "
                               "initial guess")
        defl.push(sol0.u)

    branches = [{"sol": r, "active": True,
                 "res": ContResult(alg=alg, prob=prob, contparams=cp,
                                   kind="DefContEquilibrium")}
                for r in list(defl.roots)]

    def record(branch, p, step):
        rec = prob.record_from_solution(branch["sol"], p)
        if not isinstance(rec, dict):
            rec = {"record": rec}
        rec = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)) for k, v in rec.items()}
        n_unstable = -1
        if cp.compute_eigenelements:
            vals, _, _, _ = it.kernels.eig(branch["sol"], it.kernels.as_p(p),
                                           prob.params)
            n_unstable = int(np.sum(vals.real > cp.tol_stability))
        rec.update({"param": p, "step": step, "n_unstable": n_unstable,
                    "stable": n_unstable == 0, "itnewton": 0, "itlinear": 0,
                    "ds": cp.ds, "n_imag": 0})
        branch["res"].append(rec)

    p = p0
    for b in branches:
        record(b, p, 0)

    step = 0
    ds = cp.ds
    while cp.p_min <= p + ds <= cp.p_max and step < cp.max_steps:
        p_new = p + ds
        params_new = prob.set_lens_param(prob.params, p_new)

        # ---- advance every active branch, deflating the others ----------
        for i, b in enumerate(branches):
            if not b["active"]:
                continue
            others = [bb["sol"] for j, bb in enumerate(branches)
                      if bb["active"] and j != i]
            defl.roots = others
            if others:
                sol = deflated_newton(prob, defl, cp.newton_options,
                                      x0=b["sol"], params=params_new)
            else:
                sol = newton(prob, cp.newton_options, x0=b["sol"],
                             params=params_new)
            ok = bool(sol.converged)
            if ok and alg.accept_solution is not None:
                ok = alg.accept_solution(sol.u, p_new)
            if ok:
                b["sol"] = sol.u
                record(b, p_new, step + 1)
            else:
                b["active"] = False
                b["res"].specialpoint.append(SpecialPoint(
                    type="endpoint", param=p, step=step,
                    interval=(p, p), x=b["sol"]))
                if verbosity > 0:
                    print(f"[defcont] branch {i} terminated at p={p:.6g}")

        # ---- seek new branches ------------------------------------------
        n_active = sum(b["active"] for b in branches)
        if (step % alg.seek_every_step == 0 and n_active > 0
                and n_active < alg.max_branches):
            found = 0
            for i, b in enumerate(list(branches)):
                if not b["active"] or found >= alg.max_new_branches:
                    continue
                defl.roots = [bb["sol"] for bb in branches if bb["active"]]
                if alg.perturb_solution is not None:
                    x0 = alg.perturb_solution(b["sol"], p_new, i)
                else:
                    x0 = tree_axpy(alg.perturb_factor,
                                   tree_randn_like(gen, b["sol"]), b["sol"])
                sol = deflated_newton(prob, defl, cp.newton_options,
                                      x0=x0, params=params_new)
                if not sol.converged:
                    continue
                scale = 1e-6 * (1 + float(tree_norm(sol.u)))
                ok = all(float(tree_norm(tree_sub(sol.u, bb["sol"]))) > scale
                         for bb in branches if bb["active"])
                if ok and alg.accept_solution is not None:
                    ok = alg.accept_solution(sol.u, p_new)
                if ok:
                    nb = {"sol": sol.u, "active": True,
                          "res": ContResult(alg=alg, prob=prob,
                                            contparams=cp,
                                            kind="DefContEquilibrium")}
                    branches.append(nb)
                    record(nb, p_new, step + 1)
                    found += 1
                    if verbosity > 0:
                        print(f"[defcont] new branch found at p={p_new:.6g}")

        p = p_new
        step += 1
        if not any(b["active"] for b in branches):
            break

    return DCResult(prob=prob, branches=[b["res"] for b in branches],
                    alg=alg)
