"""Traveling waves by the freezing method — the port of
`jl_tpu/wave/freezing.py` (ref src/wave/WaveProblem.jl).

Seek (u, s) with  F(u, p) + s * T u = 0  (co-moving frame; T = Lie
generator, e.g. translation d/dx) plus the phase condition
<u - uref, T uref> = 0 (ref TWModel functional, :31-110).  Multiple
generators give one speed and one phase row each.

The augmented problem is an ordinary `BifurcationProblem` over
X = [u, s_1..s_k]; the wave spectrum comes from the co-moving-frame
jacobian J + sum_i s_i T_i through the engine's `eig_jacobian` hook (the
reference's `EigenWave` strips the constraint rows, ref
src/wave/EigSolver.jl:6-45), computed as `torch.func.jacfwd` of the
co-moving field.  The wave's model goes through forward AD, so its F and
generators are plain PyTorch (a kernel refuses derivative-carrying
operands).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Union

import torch
from torch.func import jacfwd

from ..core.lens import Lens, as_lens
from ..core.problem import BifurcationProblem
from ..core.state import ravel


def travelling_wave_problem(prob_vf: BifurcationProblem,
                            generators: Union[Callable, Sequence[Callable]],
                            u0=None, speeds0=None, params=None,
                            uref=None, update_ref_every_step: int = 0):
    """Build the freezing-method problem.

    generators: linear operator(s) u -> T u (e.g. spectral/FD d/dx).
    Returns a BifurcationProblem over X = [u_flat, s_1..s_k] on u0's
    device and dtype; `update_ref_every_step > 0` re-anchors the phase
    condition on the current profile every that many steps."""
    if callable(generators):
        generators = (generators,)
    k = len(generators)
    params = prob_vf.params if params is None else params
    u0 = prob_vf.u0 if u0 is None else u0
    flat0, unravel = ravel(u0)
    n = flat0.shape[0]
    like = dict(dtype=flat0.dtype, device=flat0.device)
    speeds0 = torch.zeros(k, **like) if speeds0 is None \
        else torch.as_tensor(speeds0, **like).reshape(k)

    uref0 = flat0 if uref is None else ravel(uref)[0]
    Tflat = [lambda v, T=T: ravel(T(unravel(v)))[0] for T in generators]
    Turef0 = torch.stack([tf(uref0) for tf in Tflat])   # (k, n)

    def split(X):
        return X[:n], X[n:]

    def co_moving(u, s, inner):
        out = ravel(prob_vf.F(unravel(u), inner))[0]
        for i, tf in enumerate(Tflat):
            out = out + s[i] * tf(u)
        return out

    def G(X, par):
        u, s = split(X)
        phases = par["_Turef"] @ (u - par["_uref"])
        return torch.cat([co_moving(u, s, par["_inner"]), phases])

    inner_lens = as_lens(prob_vf.lens)
    lens = Lens(
        get=lambda par: inner_lens.get(par["_inner"]),
        set=lambda par, v: {**par, "_inner": inner_lens.set(par["_inner"],
                                                            v)},
        name=f"tw/{inner_lens.name}")

    def record(X, p, **kw):
        u, s = split(X)
        out = {"param": p, "norm": torch.linalg.vector_norm(u)}
        for i in range(k):
            out[f"speed{i}" if k > 1 else "speed"] = s[i]
        return out

    def eig_jacobian(X, par):
        """Co-moving-frame jacobian J(u) + sum s_i T_i, dense (n, n)
        (ref EigenWave, src/wave/EigSolver.jl:6-45)."""
        u, s = split(X)
        return jacfwd(lambda v: co_moving(v, s, par["_inner"]))(u)

    def update(it, state):
        if update_ref_every_step <= 0 or \
                state.step % update_ref_every_step != 0:
            return None
        u, _ = split(ravel(state.z.u)[0])
        return {**it.current_params, "_uref": u,
                "_Turef": torch.stack([tf(u) for tf in Tflat])}

    tw = BifurcationProblem(
        G, u0=torch.cat([flat0, speeds0]),
        params={"_inner": params, "_uref": uref0, "_Turef": Turef0},
        lens=lens, record_from_solution=record, update=update)
    object.__setattr__(tw, "eig_jacobian", eig_jacobian)
    object.__setattr__(tw, "inner_prob", prob_vf)
    object.__setattr__(tw, "n_inner", n)
    object.__setattr__(tw, "unravel_inner", unravel)
    return tw


@dataclasses.dataclass(frozen=True)
class EigenWave:
    """Alias marker: the wave spectrum is produced by the co-moving-frame
    jacobian via `eig_jacobian`; any standard eigensolver works on top."""

    eigsolver: Any = None
