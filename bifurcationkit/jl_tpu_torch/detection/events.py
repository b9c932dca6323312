"""Event system (ref src/events/Event.jl, EventDetection.jl) — the port's
own copy of `jl_tpu/detection/events.py`.

User test functions evaluated along the branch; sign changes (continuous) or
value changes (discrete) trigger bisection localization, mirroring the
bifurcation bisection.  Built-ins reproduce `SaveAtEvent`, `FoldDetectEvent`
and `BifDetectEvent` (ref src/events/BifurcationDetection.jl).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from .points import SpecialPoint


@dataclasses.dataclass(frozen=True)
class ContinuousEvent:
    """condition(it, state) -> scalar or tuple; an event occurs where a
    component crosses zero (ref src/events/Event.jl:78)."""

    nb: int
    condition: Callable
    compute_eigenelements: bool = False
    labels: Optional[Sequence[str]] = None
    tol: float = -1.0   # <0: use contparams.tol_param_bisection_event

    @property
    def is_continuous(self):
        return True


@dataclasses.dataclass(frozen=True)
class DiscreteEvent:
    """condition(it, state) -> integer(s); an event occurs where the value
    changes (ref src/events/Event.jl:131)."""

    nb: int
    condition: Callable
    compute_eigenelements: bool = False
    labels: Optional[Sequence[str]] = None

    @property
    def is_continuous(self):
        return False


@dataclasses.dataclass(frozen=True)
class PairOfEvents:
    """Continuous + discrete composite (ref src/events/Event.jl:197)."""

    eventC: ContinuousEvent
    eventD: DiscreteEvent

    @property
    def nb(self):
        return self.eventC.nb + self.eventD.nb

    @property
    def is_continuous(self):
        return False

    @property
    def labels(self):
        lc = self.eventC.labels or ["userC"] * self.eventC.nb
        ld = self.eventD.labels or ["userD"] * self.eventD.nb
        return list(lc) + list(ld)

    @property
    def n_continuous(self):
        return self.eventC.nb

    def condition(self, it, state):
        c = np.atleast_1d(np.asarray(self.eventC.condition(it, state),
                                     dtype=float))
        d = np.atleast_1d(np.asarray(self.eventD.condition(it, state),
                                     dtype=float))
        return np.concatenate([c, d])


@dataclasses.dataclass(frozen=True)
class SetOfEvents:
    """Arbitrary composite of events (ref src/events/Event.jl:248)."""

    events: Tuple[Any, ...]

    @property
    def nb(self):
        return sum(e.nb for e in self.events)

    @property
    def is_continuous(self):
        return all(getattr(e, "is_continuous", False) for e in self.events)

    def condition(self, it, state):
        out = []
        for e in self.events:
            out.append(np.atleast_1d(np.asarray(e.condition(it, state),
                                                dtype=float)))
        return np.concatenate(out)


def save_at_event(positions: Sequence[float]) -> ContinuousEvent:
    """`SaveAtEvent` — record points at given parameter values
    (ref src/events/BifurcationDetection.jl:10)."""
    positions = tuple(positions)

    def cond(it, state):
        return tuple(state.p - pos for pos in positions)

    return ContinuousEvent(nb=len(positions), condition=cond,
                           labels=[f"save-{p}" for p in positions])


def bif_detect_event() -> DiscreteEvent:
    """`BifDetectEvent` — expose bifurcation detection through the event
    system (ref src/events/BifurcationDetection.jl:48): the event value is
    the current number of unstable eigenvalues, so any change marks a
    bifurcation (useful when detect_bifurcation must stay <= 1)."""

    def cond(it, state):
        return (state.n_unstable[0],)

    return DiscreteEvent(nb=1, condition=cond, compute_eigenelements=True,
                         labels=["bif"])


def fold_detect_event() -> ContinuousEvent:
    """Detect folds as zeros of tau.p (ref `FoldDetectEvent`)."""

    def cond(it, state):
        return (float(state.tau.p),)

    return ContinuousEvent(nb=1, condition=cond, labels=["fold"])


# ---------------------------------------------------------------------------
# engine hooks
# ---------------------------------------------------------------------------


def update_event(it, state):
    vals = np.atleast_1d(np.asarray(it.event.condition(it, state),
                                    dtype=float))
    prev = state.event_values[0] if state.event_values is not None else vals
    state.event_values = (vals, prev)


def _crossing_indices(state, is_continuous: bool, n_continuous=None):
    cur, prev = state.event_values
    out = []
    for i in range(len(cur)):
        cont = is_continuous or (n_continuous is not None
                                 and i < n_continuous)
        if cont:
            if np.sign(cur[i]) * np.sign(prev[i]) < 0:
                out.append(i)
        elif cur[i] != prev[i]:
            out.append(i)
    return out


def locate_event(it, state, res, verbose: bool = False):
    """Bisection localization of an event crossing; mirrors the bifurcation
    bisection (ref locate_event!, src/events/EventDetection.jl:28)."""
    cp = it.contparams
    event = it.event
    idxs = _crossing_indices(state, getattr(event, "is_continuous", True),
                             getattr(event, "n_continuous", None))
    if not idxs:
        return None

    best = None
    if cp.detect_event == 2 and abs(state.ds) >= cp.dsmin_bisection:
        best = _bisect_event(it, state, verbose)

    label = "userC" if getattr(event, "is_continuous", True) else "userD"
    labels = getattr(event, "labels", None)
    if labels is not None and len(idxs) == 1 and idxs[0] < len(labels):
        label = labels[idxs[0]]
    at = best if best is not None else state
    return SpecialPoint(
        type=label,
        idx=len(res),
        param=at.p,
        norm=float(it.norm(at.z.u)),
        x=at.z.u,
        tau=at.tau,
        step=state.step,
        status="converged" if best is not None else "guess",
        interval=(min(at.p, at.p_old), max(at.p, at.p_old)),
    )


def _bisect_event(it, state, verbose: bool = False):
    """Bisection on the event zero, replaying the continuation iterator with
    halved, sign-flipping ds — the same scheme as the bifurcation bisection
    (ref locate_event!, src/events/EventDetection.jl:28).  Leaves `state` at
    the iterate closest to the crossing."""
    cp = it.contparams
    idxs = _crossing_indices(state, getattr(it.event, "is_continuous", True),
                             getattr(it.event, "n_continuous", None))
    if not idxs:
        return
    comp = idxs[0]
    post_sign = np.sign(state.event_values[0][comp])

    bis = state.copy()
    bis.in_bisection = True
    bis.stepsizecontrol = False
    bis.ds = -bis.ds
    bis.step = 0

    tol = max(cp.tol_param_bisection_event, 1e-15)
    best = state.copy()
    best_val = abs(state.event_values[0][comp])
    prev_sign = post_sign
    n_steps = 0
    while (n_steps < cp.max_bisection_steps
           and abs(bis.ds) > cp.dsmin_bisection):
        it.iterate(bis)
        if not bis.converged:
            break
        update_event(it, bis)
        cur_val = bis.event_values[0][comp]
        if abs(cur_val) < best_val:
            best_val = abs(cur_val)
            best = bis.copy()
        # reverse whenever the sign CHANGES from the previous iterate
        # (comparing against the fixed post-crossing sign breaks down after
        # the first reversal and walks AWAY from the crossing)
        if np.sign(cur_val) == prev_sign:
            bis.ds /= 2        # not crossed since last iterate: keep going
        else:
            bis.ds /= -2       # crossed: reverse
        prev_sign = np.sign(cur_val)
        n_steps += 1
        if verbose:
            print(f"  [event-bisection] step={n_steps} p={bis.p:.10f} "
                  f"val={cur_val:.3e} ds={bis.ds:.3e}")
        if abs(bis.p - bis.p_old) < tol or best_val < tol:
            break
    # record the closest iterate, but leave the CONTINUATION state strictly
    # on the post-crossing side so the event does not re-trigger on the next
    # step (ref: bisection ends just past the point)
    cur0 = state.event_values[0][comp]
    if np.sign(best.event_values[0][comp]) != post_sign:
        # best sits on the pre side: keep the original post-side state for
        # continuing, and re-arm its event values
        state.event_values = (state.event_values[0], state.event_values[0])
        return best
    state.z = best.z
    # deliberately KEEP the original tau and z_old: the bisection replays
    # with reversed ds, so best.tau points BACKWARD along the branch —
    # adopting it sends the continuation back to re-cross the event
    state.eigvals = best.eigvals
    state.eigvecs = best.eigvecs
    state.event_values = (best.event_values[0], best.event_values[0])
    return best
