"""Nd-kernel normal forms (ref get_normal_formNd, src/NormalForms.jl:656-899)
and the reduced-equation root solve used by `multicontinuation`
(ref src/bifdiagram/BranchSwitching.jl:234-441) — the port of
`jl_tpu/normal_forms/codim1_nd.py`.  The kernel bases and the jets live on
the state's device; the small N-dimensional algebra (Gram matrices, the
reduced equation and its deflated roots) runs on the host with numpy."""
from __future__ import annotations

from itertools import product
from typing import List

import numpy as np
import torch

from ..detection.points import NdBranchPoint
from ..linalg.eig import dense_eig
from .codim1 import _FlatProblem


def _rdot(x, y):
    return float(torch.real(torch.sum(torch.conj(x) * y)))


def biorthogonalise(zetas, zetas_ad):
    """Make <zeta_i, zeta*_j> = delta_ij (ref biorthogonalise,
    src/NormalForms.jl:48-92); adjusts the left vectors only."""
    N = len(zetas)
    G = np.array([[_rdot(z, za) for za in zetas_ad] for z in zetas])
    if abs(np.linalg.det(G)) <= 1e-14:
        raise RuntimeError("Gram matrix singular in biorthogonalisation; "
                           "increase nev")
    Q = np.linalg.pinv(G)
    new_ad = [sum(float(Q.T[i, j]) * zetas_ad[j] for j in range(N))
              for i in range(N)]
    G2 = np.array([[_rdot(z, za) for za in new_ad] for z in zetas])
    if np.max(np.abs(G2 - np.eye(N))) > 1e-5:
        raise RuntimeError("bi-orthogonalisation failed; increase nev")
    return zetas, new_ad


def _nd_basis_mf(fp, prob, N: int, seeds=None, precond=None,
                 gmres_opts=None, sweeps: int = 3):
    """Matrix-free N-dimensional (right, left) kernel bases by block
    bordered inverse iteration: the N-border extended operator
    [J, W; V^T, 0] is nonsingular at the bifurcation (W spans the
    cokernel estimate), and the [0; e_i]-driven solves return kernel
    vectors exactly there; re-anchoring + QR converges the block (ref
    src/NormalForms.jl:656-720, there through the eigensolver
    abstraction).  Returns (V, W, gmres) with V, W of shape (n, N)."""
    from ..codim2.minaug_mf import _make_ma_gmres

    n = fp.n
    like = fp.flat0
    if precond is None:
        precond = getattr(prob, "spectral_precond", None)
    gm = _make_ma_gmres(precond, n, 1, gmres_opts)
    eyeN = torch.eye(N, dtype=like.dtype, device=like.device)

    def solveN(Jop, cols, rows, ei):
        def op(z):
            return torch.cat([Jop(z[:n]) + cols @ z[n:], rows.T @ z[:n]])

        rhs = torch.cat([torch.zeros((n,), dtype=cols.dtype,
                                     device=cols.device), ei])
        return gm(op, rhs)[0][:n]

    if seeds is None:
        seeds = np.random.default_rng(31).standard_normal((n, N))
    V = torch.linalg.qr(torch.as_tensor(seeds).to(like))[0]
    W = V
    for _ in range(sweeps):
        V = torch.linalg.qr(torch.stack(
            [solveN(fp.dF, W, V, ei) for ei in eyeN], dim=1))[0]
        W = torch.linalg.qr(torch.stack(
            [solveN(fp.dFt, V, W, ei) for ei in eyeN], dim=1))[0]
    return V, W, gm


def get_normal_form_nd(prob, br, ind_bif: int, verbose: bool = False,
                       tol_fold: float = 1e-3, matrix_free: bool = False,
                       precond=None, gmres_opts=None):
    """Nd-kernel normal form.  `matrix_free=True` is the PDE-scale route:
    kernel/adjoint bases by block bordered inverse iteration and every
    Lyapunov-Schmidt projection through the N-border extended operator
    with preconditioned GMRES — nothing materializes the jacobian."""
    sp = br.specialpoint[ind_bif]
    N = abs(sp.delta[0])
    assert N > 1, "use get_normal_form1d for 1d kernels"
    p = sp.param
    parbif = prob.set_lens_param(prob.params, p)
    fp = _FlatProblem(prob, sp.x, parbif)
    n = fp.n
    like = fp.flat0

    seeds = None
    if sp.eigenvecs is not None and sp.eigenvals is not None:
        ind = max(int(sp.ind_ev), N)
        vecs = torch.as_tensor(sp.eigenvecs)
        seeds = torch.stack([torch.real(vecs[:, i])
                             for i in range(ind - N, ind)], dim=1).to(like)

    if matrix_free:
        Vb, Wb, gm = _nd_basis_mf(fp, prob, N, seeds=seeds, precond=precond,
                                  gmres_opts=gmres_opts)
        zetas, zetas_ad = biorthogonalise(list(Vb.T), list(Wb.T))
        cols = torch.stack(zetas_ad, dim=1)
        rows = torch.stack(zetas, dim=1)

        def op(z):
            return torch.cat([fp.dF(z[:n]) + cols @ z[n:], rows.T @ z[:n]])

        def bls(rhs):
            rhsx = torch.cat([rhs, torch.zeros((N,), dtype=rhs.dtype,
                                               device=rhs.device)])
            return gm(op, rhsx)[0][:n]
    else:
        L = fp.jacobian()
        # kernel basis: eigenvectors for the N eigenvalues closest to zero
        if seeds is not None:
            zetas = list(seeds.T)
        else:
            vals, vecs = dense_eig(L)
            order = np.argsort(np.abs(vals.real.cpu().numpy()))[:N]
            zetas = [torch.real(vecs[:, i]).to(like) for i in order]
        zetas = [z / torch.linalg.vector_norm(z) for z in zetas]

        # adjoint basis
        valsT, vecsT = dense_eig(L.T)
        orderT = np.argsort(np.abs(valsT.real.cpu().numpy()))[:N]
        zetas_ad = [torch.real(vecsT[:, i]).to(like) for i in orderT]
        zetas, zetas_ad = biorthogonalise(zetas, zetas_ad)

        # block-bordered solve: [L  Z*; Z' 0][w; s] = [rhs; 0]
        A = torch.zeros((n + N, n + N), dtype=L.dtype, device=L.device)
        A[:n, :n] = L
        for i in range(N):
            A[:n, n + i] = zetas_ad[i]
            A[n + i, :n] = zetas[i]

        def bls(rhs):
            rhsx = torch.cat([rhs, torch.zeros((N,), dtype=rhs.dtype,
                                               device=rhs.device)])
            return torch.linalg.solve(A, rhsx)[:n]

    def E(x):
        """Projection onto Range(L)."""
        for z, za in zip(zetas, zetas_ad):
            x = x - _rdot(za, x) * z
        return x

    R2, R3 = fp.d2F, fp.d3F
    R01 = fp.dFdp_at(p)
    R02 = fp.d2Fdp2_at(p)
    a01 = np.array([_rdot(R01, za) for za in zetas_ad])

    Psi01 = bls(-E(R01))
    b11 = np.zeros((N, N))
    a02 = np.zeros(N)
    R11Psi = fp.dFdp_dir(Psi01, p)
    a2v = R02 + 2 * R11Psi + R2(Psi01, Psi01)
    for j in range(N):
        tmp = fp.dFdp_dir(zetas[j], p) + R2(zetas[j], Psi01)
        for i in range(N):
            b11[i, j] = _rdot(tmp, zetas_ad[i])
        a02[j] = _rdot(a2v, zetas_ad[j])

    b20 = np.zeros((N, N, N))
    for j in range(N):
        for k in range(j, N):
            b2v = R2(zetas[j], zetas[k])
            for i in range(N):
                b20[i, j, k] = _rdot(b2v, zetas_ad[i])
                b20[i, k, j] = b20[i, j, k]

    b30 = np.zeros((N, N, N, N))
    for j in range(N):
        for k in range(N):
            for l in range(N):
                if (j == k == l) or (j == k) or (j < k < l):
                    b3v = R3(zetas[j], zetas[k], zetas[l])
                    b3v = b3v - R2(zetas[j], bls(E(R2(zetas[l], zetas[k]))))
                    b3v = b3v - R2(zetas[k], bls(E(R2(zetas[l], zetas[j]))))
                    b3v = b3v - R2(zetas[l], bls(E(R2(zetas[k], zetas[j]))))
                    for i in range(N):
                        c = _rdot(b3v, zetas_ad[i])
                        for I in {(j, k, l), (j, l, k), (k, j, l),
                                  (k, l, j), (l, j, k), (l, k, j)}:
                            b30[(i,) + I] = c

    nf = {"a01": a01, "a02": a02, "b11": b11, "b20": b20, "b30": b30}
    out = NdBranchPoint(x0=fp.flat0, p=p, params=parbif, lens=prob.lens,
                        zeta=zetas, zeta_star=zetas_ad, nf=nf, prob=prob)
    out.tau = sp.tau
    out.unravel = fp.unravel
    out.N = N
    if verbose:
        print(f"Nd normal form (N={N}): a01={a01}, b11=\n{b11}")
    return out


def reduced_equation(nf: dict, x: np.ndarray, dp: float) -> np.ndarray:
    """Evaluate the reduced system g_i(x, dp)
    (ref nf(::NdBranchPoint), src/NormalForms.jl:560-600)."""
    a01, a02 = nf["a01"], nf["a02"]
    b11, b20, b30 = nf["b11"], nf["b20"], nf["b30"]
    out = a01 * dp + a02 * dp ** 2 / 2 + (b11 @ x) * dp
    out = out + 0.5 * np.einsum("ijk,j,k->i", b20, x, x)
    out = out + np.einsum("ijkl,j,k,l->i", b30, x, x, x) / 6
    return out


def _reduced_jac(nf, x, dp):
    b11, b20, b30 = nf["b11"], nf["b20"], nf["b30"]
    J = b11 * dp + np.einsum("ijk,k->ij", b20, x)
    J = J + 0.5 * np.einsum("ijkl,k,l->ij", b30, x, x)
    return J


def nd_branch_predictors(bp: NdBranchPoint, ds: float,
                         ampfactor: float = 1.0, perturb=None,
                         n_trials: int = 30, seed: int = 11) -> List[dict]:
    """Find the nontrivial roots of the reduced equation at dp = ±|ds| with
    deflated Newton on the N-dim polynomial system; return one predictor
    per distinct root (ref multicontinuation first stage,
    src/bifdiagram/BranchSwitching.jl:234-320)."""
    nf = bp.nf
    N = len(nf["a01"])
    rng = np.random.default_rng(seed)
    preds = []

    # characteristic root radii from the dominant balances of the reduced
    # equation: |b11 dp x| ~ |b20| x^2 / 2 (transcritical-like) and
    # ~ |b30| x^3 / 6 (pitchfork-like).  At symmetric points b20 vanishes
    # and the roots sit at the cubic radius: starts cover all balances
    nb11 = max(np.abs(nf["b11"]).max(), 1e-16)
    nb20 = np.abs(nf["b20"]).max()
    nb30 = np.abs(nf["b30"]).max()
    adp = abs(ds)
    scales = [np.sqrt(adp) + adp]
    if nb20 > 1e-14:
        scales.append(2.0 * nb11 * adp / nb20)
    if nb30 > 1e-14:
        scales.append(np.sqrt(6.0 * nb11 * adp / nb30))
    scales = [s for s in scales if np.isfinite(s) and 1e-12 < s < 1e8]
    max_scale = max(scales)

    def deflated_step(x, roots, dp):
        """One Newton step on M(x) g(x) with M = prod(1/||x-r||^2 + 1) over
        known roots including the trivial one (ref: DeflationOperator-
        wrapped Newton, src/bifdiagram/BranchSwitching.jl:257-287)."""
        g = reduced_equation(nf, x, dp)
        J = _reduced_jac(nf, x, dp)
        M = 1.0
        gradM = np.zeros(N)
        for r in [np.zeros(N)] + roots:
            d = x - r
            d2 = float(d @ d)
            if d2 < 1e-24:
                return None
            f = 1.0 / d2 + 1.0
            M *= f
            gradM = gradM + (-2.0 / (d2 * d2 * f)) * d
        gradM = M * gradM
        try:
            dx = np.linalg.solve(M * J + np.outer(g, gradM), M * g)
        except np.linalg.LinAlgError:
            return None
        return x - dx

    for dp in (abs(ds), -abs(ds)):
        roots: List[np.ndarray] = []
        starts = []
        if N <= 4:
            for sigma in product((-1.0, 0.0, 1.0), repeat=N):
                if any(s != 0 for s in sigma):
                    for s_ in scales:
                        starts.append(np.asarray(sigma) * s_)
        for s_ in scales:
            starts += [rng.standard_normal(N) * s_ for _ in range(n_trials)]
        for x in starts:
            if perturb is not None:
                x = perturb(x)
            ok = True
            for _ in range(200):
                xn = deflated_step(x, roots, dp)
                if xn is None:
                    ok = False
                    break
                step = np.linalg.norm(xn - x)
                x = xn
                if step < 1e-12:
                    break
            if not ok:
                continue
            if np.linalg.norm(reduced_equation(nf, x, dp)) < 1e-9 \
                    and np.linalg.norm(x) > 1e-8 * max_scale \
                    and np.linalg.norm(x) < 100 * max_scale:
                if not any(np.linalg.norm(x - r) < 1e-6 * max(1, max_scale)
                           for r in roots):
                    roots.append(x)
        for r in roots:
            x1 = bp.x0.clone()
            for j in range(N):
                x1 = x1 + ampfactor * float(r[j]) * bp.zeta[j]
            preds.append({"x1": x1, "p": bp.p + dp, "amp": r, "dp": dp})
    return preds
