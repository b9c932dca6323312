"""What both plain references share: PALC's arclength row, judged on the
points a window recorded, and the record of a compared number."""
from __future__ import annotations

import numpy as np
import torch


def number(name: str, value: float, limit: float, **info) -> dict:
    """One compared number: it passes when value <= limit."""
    return dict(name=name, value=float(value), limit=float(limit), **info)


def at_bound(p: float, cont: dict) -> bool:
    return p <= cont["p_min"] or p >= cont["p_max"]


def ds_used(prev: dict, cur: dict, cont: dict) -> float:
    """The arclength step of the corrector that produced `cur`: the step
    `prev`'s state held, halved once for each failed attempt between the
    two (each increments the step counter), never under dsmin."""
    ds = prev["ds"]
    for _ in range(cur["step"] - prev["step"] - 1):
        ds = float(np.sign(ds) * max(abs(ds) / 2, cont["dsmin"]))
    return ds


def arclength_rows(points, theta: float, cont: dict, bisects: bool):
    """(index, |arclength row|) for every point whose predecessor in its
    job is the state its corrector started from: the PALC row
    theta <u - u0, tau.u> / n + (1 - theta) (p - p0) tau.p - ds of
    `continuation/kernels.py`, recomputed in float64.  A job's first point
    (its predecessor is the job's start-up), a point held at p_min or
    p_max (the corrector there is a plain Newton), and a point whose
    stability count changed where the traffic bisects (bisection moved
    it) have no such row."""
    out = []
    for i in range(1, len(points)):
        prev, cur = points[i - 1], points[i]
        if cur["job"] != prev["job"] or at_bound(cur["p"], cont):
            continue
        if bisects and changed(cur):
            continue
        u, u0 = cur["u"].double(), prev["u"].double()
        n = u.numel()
        dot = torch.sum((u - u0) * prev["tau_u"].double()) / n
        row = (theta * float(dot)
               + (1 - theta) * (cur["p"] - prev["p"]) * prev["tau_p"]
               - ds_used(prev, cur, cont))
        out.append((i, abs(row)))
    return out


def changed(point) -> bool:
    """The point's stability counts differ from its predecessor's, which
    is what makes `continuation` bisect."""
    return (point["n_unstable"][0] != point["n_unstable"][1]
            or point["n_imag"][0] != point["n_imag"][1])


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """A float64 tensor as float32 holds it."""
    return t.to(torch.float32).to(t.dtype)


def sample(n: int, k: int, seed: int, must=()) -> list:
    """`k` indices of `range(n)` drawn from the seed, with `must`."""
    rng = np.random.default_rng(seed)
    rest = [i for i in range(n) if i not in set(must)]
    take = max(0, min(k - len(set(must)), len(rest)))
    picked = rng.choice(len(rest), size=take, replace=False) if take else []
    return sorted(set(must) | {rest[i] for i in picked})
