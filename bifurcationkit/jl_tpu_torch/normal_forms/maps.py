"""Normal forms for fixed points of maps: period-doubling (flip) and
Neimark-Sacker — the port of `jl_tpu/normal_forms/maps.py` (ref
src/NormalForms.jl:1295-1635; coefficients after Kuznetsov, Elements of
Applied Bifurcation Theory, §5.4).

`prob` holds the map G(x, params); the bifurcating fixed point satisfies
G(x0) = x0 with multiplier -1 (PD) or exp(i theta0) (NS).  The forms of
one stage are gathered into one `_FlatProblem.forms` call (one batch for
the Poincare return map's jets, one `torch.func.vmap` otherwise).
"""
from __future__ import annotations

import numpy as np
import torch

from ..detection.points import NeimarkSacker, PeriodDoubling
from ..linalg.eig import dense_eig
from .codim1 import _FlatProblem, _inner


def _map_eigen(fp, which):
    """(A, mu, q, p): the map's jacobian, the critical multiplier, its unit
    eigenvector q and the adjoint vector p with <q, p> = 1."""
    A = fp.jacobian()
    vals, vecs = dense_eig(A)
    vals_np = vals.cpu().numpy()
    if which == "pd":
        i0 = int(np.argmin(np.abs(vals_np + 1.0)))
    else:
        cand = np.where(vals_np.imag > 1e-10)[0]
        if len(cand) == 0:
            raise RuntimeError("no complex multiplier found for NS")
        i0 = int(cand[np.argmin(np.abs(np.abs(vals_np[cand]) - 1.0))])
    lam = vals_np[i0]
    q = vecs[:, i0]
    q = q / torch.linalg.vector_norm(q)
    valsT, vecsT = dense_eig(A.T)
    iT = int(np.argmin(np.abs(valsT.cpu().numpy() - np.conj(lam))))
    p = vecsT[:, iT]
    p = p / _inner(q, p)
    return A, lam, q, p


def period_doubling_nf(prob, x0, params, verbose: bool = False):
    """Flip normal form coefficient c: the restricted map reads
    xi -> -xi + c xi^3 (ref PeriodDoubling NF for maps,
    src/NormalForms.jl:1295).

    MAP convention: c > 0 => supercritical (the 2-cycle xi^2 = d/c exists
    and is stable on the unstable side d > 0 iff c > 0), opposite to the
    Iooss flow convention of `periodic.normal_forms.period_doubling_iooss`
    (b3 < 0 supercritical); both vanish together at a GPD point."""
    fp = _FlatProblem(prob, x0, params)
    A, lam, q, p = _map_eigen(fp, "pd")
    q = torch.real(q)
    q = q / torch.linalg.vector_norm(q)
    p = torch.real(p)
    p = p / float(np.real(_inner(q, p)))
    eye = torch.eye(fp.n, dtype=A.dtype, device=A.device)
    Bqq, = fp.forms(fp.prob.d2F, [(q, q)])
    h2 = torch.linalg.solve(eye - A, Bqq)
    Cqqq, = fp.forms(fp.prob.d3F, [(q, q, q)])
    Bqh, = fp.forms(fp.prob.d2F, [(q, h2)])
    c = float(np.real(_inner(Cqqq + 3.0 * Bqh, p))) / 6.0
    pt = PeriodDoubling(x0=fp.flat0, p=None, params=params, lens=prob.lens,
                        zeta=q, zeta_star=p, nf={"c": c, "mu": lam},
                        prob=prob)
    pt.subtype = "SuperCritical" if c > 0 else "SubCritical"
    if verbose:
        print(f"PD normal form: c = {c:.6g} ({pt.subtype})")
    return pt


def neimark_sacker_nf(prob, x0, params, verbose: bool = False):
    """NS first Lyapunov coefficient d (ref NS NF for maps,
    src/NormalForms.jl:1386; Kuznetsov (5.87)):
    d = Re[e^{-i th} <p, C(q,q,qbar)/2 + B(qbar,(I-A)^{-1}B(q,q)...)>],
    in complex128 (the JAX package's embedding is a TPU workaround)."""
    fp = _FlatProblem(prob, x0, params)
    A, lam, q, p = _map_eigen(fp, "ns")
    theta = float(np.angle(lam))
    cd = torch.complex128
    Ac = A.to(cd)
    eye = torch.eye(fp.n, dtype=cd, device=A.device)
    q = q.to(cd)
    qb = torch.conj(q)
    Bqq, Bqqb = fp.forms(fp.prob.d2F, [(q, q), (q, qb)])
    h20 = torch.linalg.solve(complex(np.exp(2j * theta)) * eye - Ac,
                             Bqq.to(cd))
    h11 = torch.linalg.solve(eye - Ac, Bqqb.to(cd))
    Cqqqb, = fp.forms(fp.prob.d3F, [(q, q, qb)])
    Bqh11, Bqbh20 = fp.forms(fp.prob.d2F, [(q, h11), (qb, h20)])
    gv = Cqqqb + 2.0 * Bqh11 + Bqbh20
    g21 = _inner(gv, p.to(cd)) / 2.0
    # with the VI.inner conjugation, <p, v> = conj(inner(v, p))
    d = float(np.real(np.exp(-1j * theta) * np.conj(g21)))
    pt = NeimarkSacker(x0=fp.flat0, p=None, params=params, lens=prob.lens,
                       zeta=q, zeta_star=p, omega=theta,
                       nf={"d": d, "mu": lam, "g21": g21}, prob=prob)
    pt.subtype = "SuperCritical" if d < 0 else "SubCritical"
    if verbose:
        print(f"NS normal form: d = {d:.6g}, theta = {theta:.6g} "
              f"({pt.subtype})")
    return pt
