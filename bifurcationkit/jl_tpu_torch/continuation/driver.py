"""Top-level `continuation` entry point (ref src/Continuation.jl:506-708) —
the port of `jl_tpu/continuation/driver.py`."""
from __future__ import annotations

import dataclasses

from typing import Callable, Optional

from ..core.params import ContinuationPar
from ..core.state import tree_norm
from ..detection.bifurcation import (detect_bifurcation, get_bifurcation_type,
                                     locate_bifurcation, locate_fold)
from ..detection.events import locate_event, update_event
from ..detection.points import SpecialPoint
from .algorithms import PALC
from .engine import ContIterable
from .results import ContResult, merge_branches


def continuation(prob, alg=None, contparams: Optional[ContinuationPar] = None,
                 *,
                 norm: Callable = tree_norm,
                 finalise_solution: Optional[Callable] = None,
                 callback_newton: Optional[Callable] = None,
                 event=None,
                 verbosity: int = 0,
                 kind: str = "EquilibriumCont",
                 bothside: bool = False,
                 x0=None, params=None) -> ContResult:
    """Continue `F(u, p) = 0` in the problem's lens parameter.

    Mirrors `continuation(prob, alg, contparams)` (ref src/Continuation.jl:661)
    with the same detection/bisection semantics; returns a `ContResult`.
    """
    alg = alg or PALC()
    contparams = contparams or ContinuationPar()

    def run(cp):
        it = ContIterable(prob, alg, cp, norm=norm,
                          finalise_solution=finalise_solution,
                          callback_newton=callback_newton, event=event,
                          verbosity=verbosity, kind=kind)
        return _continuation_loop(it, x0=x0, params=params)

    if bothside:
        res_fw = run(contparams)
        res_bw = run(dataclasses.replace(contparams, ds=-contparams.ds))
        return merge_branches(res_fw, res_bw)
    return run(contparams)


def _continuation_loop(it: ContIterable, x0=None, params=None) -> ContResult:
    """The main loop (ref continuation!, src/Continuation.jl:506-600)."""
    cp = it.contparams
    res = ContResult(alg=it.alg, prob=it.prob, contparams=cp, kind=it.kind)

    state = it.init_state(x0=x0, params=params)
    if it.event is not None:
        update_event(it, state)
        state.event_values = (state.event_values[0], state.event_values[0])
    it.save(res, state)

    while not it.done(state):
        it.iterate(state)
        if state.converged:
            # ---- fold detection by parameter monotony -------------------
            interval0 = (min(state.p, state.p_old), max(state.p, state.p_old))

            # ---- eigenvalue-count bifurcation detection ----------------
            if cp.detect_bifurcation > 1 and detect_bifurcation(state):
                status, interval = "guess", interval0
                if cp.detect_bifurcation == 3 and \
                        abs(state.ds) >= cp.dsmin_bisection:
                    status, interval = locate_bifurcation(
                        it, state, it.verbosity > 2)
                known, sp = get_bifurcation_type(
                    it, state, status, interval,
                    is_floquet=getattr(it.kernels, "is_floquet", False))
                if known and sp is not None:
                    sp.printsol = it.record(state)
                    # suppress re-detections of the SAME crossing: near a
                    # degenerate point a borderline eigenvalue can flicker
                    # across tol_stability for several steps, re-reporting
                    # one bifurcation many times (e.g. the double +1
                    # multiplier at a PO branch point)
                    dup = any(
                        prev.type == sp.type
                        and abs(prev.param - sp.param) < 1e-6
                        and sp.step - prev.step <= 4
                        for prev in res.specialpoint)
                    if not dup:
                        res.specialpoint.append(sp)

            # ---- events -------------------------------------------------
            if it.event is not None and cp.detect_event > 0 and \
                    state.step > 0:
                update_event(it, state)
                if _event_crossed(state, it.event):
                    sp_ev = locate_event(it, state, res)
                    if sp_ev is not None:
                        # bisection can leave the state within roundoff of
                        # the crossing; the next step then re-crosses and
                        # re-reports the same event
                        dup = any(
                            prev.type == sp_ev.type
                            and abs(prev.param - sp_ev.param)
                            < 1e-7 * max(1.0, abs(sp_ev.param))
                            and sp_ev.step - prev.step <= 4
                            for prev in res.specialpoint)
                        if not dup:
                            res.specialpoint.append(sp_ev)
                    # arm for the NEXT crossing: collapse (cur, prev) so the
                    # just-located event does not re-trigger every step
                    update_event(it, state)
                    state.event_values = (state.event_values[0],
                                          state.event_values[0])

            # ---- problem update hook (re-anchoring MA borders, section
            # updates, mesh adaptation — ref update!, src/Continuation.jl:251)
            if it.prob.update is not None:
                newp = it.prob.update(it, state)
                if newp is not None:
                    it.current_params = newp

            # ---- user finalise hook ------------------------------------
            if it.finalise_solution is not None:
                keep = it.finalise_solution(state.z, state.tau, state.step,
                                            res, state=state)
                if keep is False:
                    state.stopcontinuation = True

            it.save(res, state)
            # fold uses the recorded branch history (3 points)
            locate_fold(res, it, state)

            if cp.detect_loop and _detect_loop(res):
                state.stopcontinuation = True
        if it.verbosity > 0:
            flag = "ok" if state.converged else "FAIL"
            print(f"step {state.step:4d} [{flag}] p = {state.p: .6f} "
                  f"ds = {state.ds: .3e} itnewton = {state.itnewton}")

    # final endpoint marker (ref SpecialPoint :endpoint)
    res.specialpoint.append(SpecialPoint(
        type="endpoint", idx=max(len(res) - 1, 0), param=state.p,
        step=state.step, status="converged",
        interval=(state.p, state.p), x=state.z.u, tau=state.tau))
    return res


def _event_crossed(state, event=None) -> bool:
    if state.event_values is None:
        return False
    from ..detection.events import _crossing_indices

    is_cont = getattr(event, "is_continuous", True) if event is not None \
        else True
    ncont = getattr(event, "n_continuous", None) if event is not None \
        else None
    return bool(_crossing_indices(state, is_cont, ncont))


def _detect_loop(res: ContResult, tol: float = 1e-6) -> bool:
    """Detect if the branch returned to its starting point
    (ref detect_loop, src/Utils.jl:206)."""
    if len(res) < 6:
        return False
    p0 = res.param[0]
    n0 = res._records[0].get("norm", None)
    pn = res.param[-1]
    nn = res._records[-1].get("norm", None)
    if n0 is None or nn is None:
        return False
    scale = max(abs(p0), abs(float(n0)), 1.0)
    return (abs(pn - p0) + abs(float(nn) - float(n0))) / scale < tol
