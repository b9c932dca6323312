"""Bifurcation detection & localization (ref src/Bifurcations.jl) — the
port's own copy of `jl_tpu/detection/bifurcation.py`.

Detection is a change in the number of unstable eigenvalues between two
consecutive converged points; classification reads (δn_unstable, δn_imag);
localization replays the continuation iterator in a bisection on ds
(ref :159-349).  All of it is host-side control flow over device kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..detection.points import SpecialPoint


def detect_bifurcation(state) -> bool:
    """ref src/Bifurcations.jl:22-29."""
    n1, n2 = state.n_unstable[1], state.n_unstable[0]
    if n1 == -1 or n2 == -1:
        return False
    return n1 != n2


def detect_fold(p1, p2, p3) -> bool:
    """Parameter monotony reversal (ref src/Bifurcations.jl:32)."""
    return (p3 - p2) * (p2 - p1) < 0


def locate_fold(res, it, state) -> bool:
    """Fold by param monotony; records a :fold SpecialPoint at the previous
    branch row (ref locate_fold!, src/Bifurcations.jl:35-67)."""
    if not it.contparams.detect_fold or len(res) <= 2:
        return False
    p1, p2, p3 = res.param[-3], res.param[-2], res.param[-1]
    if not detect_fold(p1, p2, p3):
        return False
    sp = SpecialPoint(
        type="fold",
        idx=len(res) - 2,
        param=float(p2),
        norm=float(it.norm(state.z.u)),
        printsol=res[len(res) - 2],
        x=state.z.u,
        tau=state.tau,
        ind_ev=0,
        step=int(res[len(res) - 2]["step"]),
        status="guess",
        delta=(0, 0),
        precision=-1.0,
        interval=(float(min(p2, p3)), float(max(p2, p3))),
    )
    # suppress re-detection of the same fold when the branch stalls and the
    # parameter oscillates around the turning point for several steps
    dup = any(prev.type == "fold"
              and abs(prev.param - sp.param) < 1e-6
              and sp.step - prev.step <= 4
              for prev in res.specialpoint)
    if not dup:
        res.specialpoint.append(sp)
    return True


def get_bifurcation_type(it, state, status: str,
                         interval: Tuple[float, float],
                         is_floquet: bool = False):
    """Coarse classification from eigenvalue-count deltas
    (ref _get_bifurcation_type, src/Bifurcations.jl:80-151)."""
    n_unstable, n_unstable_prev = state.n_unstable
    n_imag, n_imag_prev = state.n_imag

    ind_ev = n_unstable_prev if n_unstable < n_unstable_prev else n_unstable
    tp = "none"
    dn_unstable = abs(n_unstable - n_unstable_prev)
    dn_imag = abs(n_imag - n_imag_prev)

    known = False
    if dn_unstable == 1:
        if dn_imag == 0:
            tp = "bp"
        elif dn_imag == 1:
            tp = "pd" if is_floquet else "hopf"
        else:
            tp = "nd"
        known = True
    elif dn_unstable == 2:
        tp = ("ns" if is_floquet else "hopf") if dn_imag == 2 else "nd"
        known = True
    elif dn_unstable > 2:
        tp = "nd"
        known = True

    if dn_unstable < dn_imag:
        tp = "nd"
        known = True
    if n_unstable * n_unstable_prev < 0 or n_imag * n_imag_prev < 0:
        tp = "nd"
        known = True
    if not known:
        return False, None

    sp = SpecialPoint(
        type=tp,
        idx=state.step + 1,
        param=state.p,
        norm=float(it.norm(state.z.u)),
        printsol=None,
        x=state.z.u,
        tau=state.tau,
        ind_ev=int(ind_ev),
        step=state.step,
        status=status,
        delta=(n_unstable - n_unstable_prev, n_imag - n_imag_prev),
        precision=abs(interval[1] - interval[0]),
        interval=(float(min(interval)), float(max(interval))),
        eigenvals=None if state.eigvals is None else state.eigvals.copy(),
        eigenvecs=state.eigvecs,
    )
    return True, sp


def locate_bifurcation(it, _state, verbose: bool = False):
    """Bisection localization of a bifurcation point; leaves `_state` just
    AFTER the point in arclength (ref locate_bifurcation!,
    src/Bifurcations.jl:159-349)."""
    if not detect_bifurcation(_state):
        raise ValueError("no bifurcation detected for this state")
    n2, n1 = _state.n_unstable[0], _state.n_unstable[1]
    if n1 == -1 or n2 == -1:
        return "none", (0.0, 0.0)

    cp = it.contparams
    if abs(_state.ds) < cp.dsmin:
        return "none", (0.0, 0.0)

    after = _state.copy()     # will hold the state after the point
    state = _state.copy()     # bisection iterate
    before = _state.copy()    # state before the point
    before.n_unstable = (before.n_unstable[1], before.n_unstable[0])
    before.n_imag = (before.n_imag[1], before.n_imag[0])
    before.z, before.z_old = \
        dataclasses.replace(before.z, p=before.z_old.p), \
        dataclasses.replace(before.z_old, p=before.z.p)

    state.in_bisection = True
    state.ds = -state.ds
    state.step = 0
    state.stepsizecontrol = False

    nunstbls = [n2]
    nimags = [state.n_imag[0]]

    p_cur, p_prev = state.p, state.p_old
    interval = (min(p_cur, p_prev), max(p_cur, p_prev))
    indinterval = 0 if interval[0] == p_cur else 1

    n_inversion = 0
    status = "guess"
    biflocated = False
    # NOTE: do not recompute the secant tangent after flipping ds — the
    # tangent keeps its global orientation (it is refreshed inside
    # iterate() after each converged step); only the predictor z + ds*tau
    # depends on the flipped ds (ref update_predictor!, Bifurcations.jl:245)

    first = True
    while True:
        if not state.converged:
            break
        if not first:
            nunstbls.append(state.n_unstable[0])
            nimags.append(state.n_imag[0])
            if nunstbls[-1] == nunstbls[-2]:
                state.ds /= 2
            else:
                state.ds /= -2
                n_inversion += 1
                indinterval = 0 if indinterval == 1 else 1
            if n_inversion % 2 == 0:
                after = state.copy()
            else:
                before = state.copy()
            if state.step > 0:
                iv = list(interval)
                iv[indinterval] = state.p
                interval = tuple(iv)
            if state.eigvals is not None and len(state.eigvals):
                vals = state.eigvals
                if getattr(it.kernels, "is_floquet", False):
                    # exclude the trivial Floquet exponent (log of the unit
                    # multiplier, ~0 for any well-converged orbit) — it is
                    # not the bifurcating eigenvalue and would trigger the
                    # located-early exit spuriously
                    itriv = int(np.argmin(np.abs(vals)))
                    vals = np.delete(vals, itriv)
                rightmost_re = np.max(vals.real) if len(vals) else np.inf
                biflocated = abs(rightmost_re) < cp.tol_bisection_eigenvalue

            if not (abs(state.ds) >= cp.dsmin_bisection
                    and state.step < cp.max_bisection_steps
                    and n_inversion < cp.n_inversion
                    and not biflocated):
                break
        first = False
        it.iterate(state)
        if verbose:
            print(f"  [bisection] step={state.step} ds={state.ds:.3e} "
                  f"p={state.p:.8f} n_unstable={state.n_unstable} "
                  f"inversions={n_inversion}")

    if n_inversion % 2 == 0:
        status = "converged" if n_inversion >= cp.n_inversion else "guess"
        _state.z = state.z
        _state.z_old = state.z_old
        _state.tau = state.tau
        _state.eigvals = state.eigvals
        if cp.save_eigenvectors:
            _state.eigvecs = state.eigvecs
        _state.n_unstable = (state.n_unstable[0], before.n_unstable[0])
        _state.n_imag = (state.n_imag[0], before.n_imag[0])
        interval = (state.p, before.p)
    else:
        status = "guessL"
        _state.z = after.z
        _state.z_old = after.z_old
        _state.tau = after.tau
        _state.eigvals = after.eigvals
        if cp.save_eigenvectors:
            _state.eigvecs = after.eigvecs
        _state.n_unstable = (after.n_unstable[0], state.n_unstable[0])
        _state.n_imag = (after.n_imag[0], state.n_imag[0])
        interval = (state.p, after.p)
    it.update_predictor(_state)
    return status, (float(min(interval)), float(max(interval)))
