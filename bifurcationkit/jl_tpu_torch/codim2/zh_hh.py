"""Zero-Hopf and Hopf-Hopf normal-form coefficients — the port of
`jl_tpu/codim2/zh_hh.py` (ref src/codim2/NormalForms.jl:959-1574;
Kuznetsov §8.5-8.6).

ZH (eigenvalues {0, +-i w}; q0 real null vector, q1 Hopf eigenvector):
    x' = 1/2 G200 x^2 + G011 |z|^2 + ...
    z' = i w z + G110 x z + ...
    G200 = <p0, B(q0, q0)>,  G011 = <p0, B(q1, conj q1)>,
    G110 = <p1, B(q0, q1)>

HH (eigenvalues {+-i w1, +-i w2}; q1, q2 the two Hopf eigenvectors):
    z1' = i w1 z1 + z1 (G2100 |z1|^2 + G1011 |z2|^2) + ...
    z2' = i w2 z2 + z2 (G1110 |z1|^2 + G0021 |z2|^2) + ...
"""
from __future__ import annotations

import numpy as np
import torch

from ..detection.points import HopfHopf, ZeroHopf
from ..linalg.eig import dense_eig
from ..normal_forms.codim1 import _FlatProblem
from .unfolding import _dot, _zh_basis_mf

_C = torch.complex128


def _pair(A, target):
    """(eigenvalue, right vector, left vector with <p, q> = 1) nearest
    `target`, from host eigs of A and A^T."""
    vals, vecs = dense_eig(A)
    vals = vals.cpu().numpy()
    i0 = int(np.argmin(np.abs(vals - target)))
    lam = vals[i0]
    q = vecs[:, i0] / torch.linalg.vector_norm(vecs[:, i0])
    valsT, vecsT = dense_eig(A.T)
    p = vecsT[:, int(np.argmin(np.abs(valsT.cpu().numpy() - np.conj(lam))))]
    return lam, q, p / np.conj(_dot(p, q))


def _zh_coefficients(fp, q0, p0, q1, p1):
    B = fp.d2F
    G200 = float(torch.real(torch.dot(p0, B(q0, q0))))
    G011 = float(np.real(_dot(p0.to(_C), B(q1, torch.conj(q1)))))
    G110 = _dot(p1, B(q0, q1))
    return {"G200": G200, "G011": G011, "G110": G110}


def zh_normal_form(prob, x0, params, verbose: bool = False,
                   matrix_free: bool = False, precond=None,
                   gmres_opts=None, omega=None, seed=None):
    """Quadratic ZH coefficients (ref ZH NF, src/codim2/NormalForms.jl:959).

    `matrix_free=True` takes the (q0, p0) null pair and the (q1, p1) Hopf
    pair by bordered inverse iteration (`unfolding._zh_basis_mf`); the
    quadratic G's are then projections of the jets, with no solve."""
    fp = _FlatProblem(prob, x0, params)
    if matrix_free:
        q0, p0, q1, p1, w, _, _, _ = _zh_basis_mf(
            fp, prob, params, precond=precond, gmres_opts=gmres_opts,
            omega=omega, seed=seed)
    else:
        A = fp.jacobian().to(_C)
        _, q0c, p0c = _pair(A, 0.0 + 0.0j)
        q0 = torch.real(q0c)
        q0 = q0 / torch.linalg.vector_norm(q0)
        p0 = torch.real(p0c)
        p0 = p0 / torch.dot(p0, q0)
        vals = dense_eig(A, with_vectors=False)[0].cpu().numpy()
        cand = vals[vals.imag > 1e-8]
        if len(cand) == 0:
            raise RuntimeError("no Hopf pair at the ZH candidate")
        lamH = cand[np.argmin(np.abs(cand.real))]
        _, q1, p1 = _pair(A, lamH)
        w = float(np.imag(lamH))
    nf = _zh_coefficients(fp, q0, p0, q1, p1)
    pt = ZeroHopf(x0=fp.flat0, p=None, params=params, lens=prob.lens,
                  zeta=(q0, q1), zeta_star=(p0, p1), omega=w, nf=nf,
                  prob=prob)
    if verbose:
        print(f"ZH NF: G200={nf['G200']:.6g} G011={nf['G011']:.6g} "
              f"G110={nf['G110']:.6g} omega={w:.6g}")
    return pt


def hh_normal_form(prob, x0, params, verbose: bool = False):
    """Cubic HH coefficients (ref HH NF, src/codim2/NormalForms.jl:1315)
    in the basis with ||q_k|| = 1, <p_k, q_k> = 1 and w1 < w2.

    The individual G's rescale with the eigenvector amplitudes (the
    reference's gold asserts are commented out for that reason,
    testNF.jl:690-693); the Kuznetsov classification invariants
    delta = Re G1110 / Re G2100, theta = Re G1011 / Re G0021 and the signs
    of Re G2100, Re G0021 are basis-free."""
    fp = _FlatProblem(prob, x0, params)
    A = fp.jacobian().to(_C)
    n = fp.n
    vals = dense_eig(A, with_vectors=False)[0].cpu().numpy()
    cand = vals[vals.imag > 1e-8]
    if len(cand) < 2:
        raise RuntimeError("need two Hopf pairs at an HH candidate")
    # the two pairs closest to the imaginary axis, ordered w1 < w2
    pair = cand[np.argsort(np.abs(cand.real))[:2]]
    lam1, lam2 = pair[np.argsort(pair.imag)]
    if abs(lam1.imag - lam2.imag) < 1e-10:
        raise RuntimeError("the two Hopf pairs coincide")
    _, q1, p1 = _pair(A, lam1)
    _, q2, p2 = _pair(A, lam2)
    w1, w2 = float(lam1.imag), float(lam2.imag)
    eye = torch.eye(n, dtype=_C, device=A.device)
    B, C = fp.d2F, fp.d3F

    def solve(sig, b):
        return torch.linalg.solve(sig * eye - A, b.to(_C))

    cq1, cq2 = torch.conj(q1), torch.conj(q2)
    # second-order h-solves (non-resonant for w1 != w2, w1 != 3 w2, ...)
    h1100 = solve(0.0, B(q1, cq1))
    h0011 = solve(0.0, B(q2, cq2))
    h2000 = solve(2j * w1, B(q1, q1))
    h0020 = solve(2j * w2, B(q2, q2))
    h1010 = solve(1j * (w1 + w2), B(q1, q2))
    h1001 = solve(1j * (w1 - w2), B(q1, cq2))

    # resonant projections (the z1 z2 zb2 products are B(q2, h1001),
    # B(qb2, h1010), B(q1, h0011))
    nf = {"G2100": _dot(p1, C(q1, q1, cq1) + B(cq1, h2000)
                       + 2.0 * B(q1, h1100)) / 2.0,
          "G1011": _dot(p1, C(q1, q2, cq2) + B(q1, h0011) + B(q2, h1001)
                       + B(cq2, h1010)),
          "G1110": _dot(p2, C(q2, q1, cq1) + B(q2, h1100)
                       + B(q1, torch.conj(h1001)) + B(cq1, h1010)),
          "G0021": _dot(p2, C(q2, q2, cq2) + B(cq2, h0020)
                       + 2.0 * B(q2, h0011)) / 2.0}
    pt = HopfHopf(x0=fp.flat0, p=None, params=params, lens=prob.lens,
                  zeta=(q1, q2), zeta_star=(p1, p2), omega1=w1, omega2=w2,
                  nf=nf, prob=prob)
    if verbose:
        print("HH NF: " + " ".join(f"{k}={v:.6g}" for k, v in nf.items()))
    return pt
