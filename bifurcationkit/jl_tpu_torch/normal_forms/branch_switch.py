"""Automatic branch switching (ref src/bifdiagram/BranchSwitching.jl) —
the port of `jl_tpu/normal_forms/branch_switch.py`.

`continuation_from_bp(br, ind_bif, ...)` computes the normal form at a simple
branch point, builds the normal-form predictor for the bifurcated branch, and
launches a new continuation from the predicted point (ref :74-198).
`multicontinuation` handles Nd points by solving the reduced polynomial
equations with deflated Newton and continuing every root (ref :234-441).
"""
from __future__ import annotations

from typing import Optional

from ..continuation.algorithms import PALC
from ..continuation.driver import continuation
from ..continuation.results import Branch
from ..core.params import ContinuationPar
from .codim1 import get_normal_form, predictor


def _switched_problem(prob, nf, pred):
    """The problem restarted at the predictor's point."""
    unravel = getattr(nf, "unravel", lambda v: v)
    p1 = float(pred["p"])
    return prob.re_make(u0=unravel(pred["x1"]),
                        params=prob.set_lens_param(prob.params, p1))


def continuation_from_bp(br, ind_bif: int,
                         contparams: Optional[ContinuationPar] = None,
                         alg=None, *, delta_p: Optional[float] = None,
                         ampfactor: float = 1.0, use_normal_form: bool = True,
                         nev: Optional[int] = None, verbose: bool = False,
                         nf_kwargs: Optional[dict] = None,
                         **cont_kwargs) -> Branch:
    """Branch switching at a simple branch point (aBS)
    (ref continuation(br, ind_bif, ...), src/bifdiagram/BranchSwitching.jl:74).
    `nf_kwargs` passes through to the normal-form computation — e.g.
    `{"matrix_free": True}` for the PDE-scale route (the reference's
    `get_normal_form(br, 19)` + aBS at 15,100 dof, SH2d-fronts.jl:95)."""
    prob = br.prob
    contparams = contparams or br.contparams
    alg = alg or PALC()
    sp = br.specialpoint[ind_bif]
    if sp.type == "hopf":
        raise ValueError("use periodic-orbit continuation to branch from a "
                         "Hopf point")

    nf = get_normal_form(br, ind_bif, prob=prob, verbose=verbose,
                         **(nf_kwargs or {}))
    ds = delta_p if delta_p is not None else contparams.ds
    pred = predictor(nf, ds, ampfactor=ampfactor, verbose=verbose)
    if pred is None:
        raise RuntimeError(f"no branch-switching predictor at point "
                           f"{ind_bif} (type {type(nf).__name__})")
    gamma = continuation(_switched_problem(prob, nf, pred), alg, contparams,
                         **cont_kwargs)
    return Branch(gamma=gamma, bp=nf)


def multicontinuation(br, ind_bif: int,
                      contparams: Optional[ContinuationPar] = None,
                      alg=None, *, delta_p: Optional[float] = None,
                      ampfactor: float = 1.0, perturb=None,
                      nf_kwargs: Optional[dict] = None,
                      verbose: bool = False, **cont_kwargs):
    """Branch switching at an Nd branch point: find the zeros of the reduced
    polynomial system with deflated Newton, continue each
    (ref multicontinuation, src/bifdiagram/BranchSwitching.jl:234-441)."""
    from .codim1_nd import nd_branch_predictors

    prob = br.prob
    contparams = contparams or br.contparams
    alg = alg or PALC()
    nf = get_normal_form(br, ind_bif, prob=prob, verbose=verbose,
                         **(nf_kwargs or {}))
    ds = delta_p if delta_p is not None else contparams.ds

    branches = []
    for pred in nd_branch_predictors(nf, ds, ampfactor=ampfactor,
                                     perturb=perturb):
        try:
            gamma = continuation(_switched_problem(prob, nf, pred), alg,
                                 contparams, **cont_kwargs)
        except RuntimeError:
            continue
        branches.append(Branch(gamma=gamma, bp=nf))
    return nf, branches
