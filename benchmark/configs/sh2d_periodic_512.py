"""The builder of `sh2d_periodic_512`: the port's periodic Swift-Hohenberg
at the upstream GPU example's size, its solvers as the configuration file
states them, and one job of the traffic mix.

The traffic's `seed` section says what the seed draws: a perturbation of
the model's initial guess of the given amplitude, and the eigensolver's
start block where `eigensolver_start_block` is set (else the
eigensolver's own seed).
"""
from __future__ import annotations

import time

import torch

import bifurcationkit.jl_tpu_torch as bk
from bifurcationkit.jl_tpu_torch import models

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def solvers(cfg, prob, seed: int):
    lsc, inner = cfg["linear_solver"], cfg["linear_solver"]["inner"]
    ls = bk.IterativeRefinement(
        inner=bk.GMRES(restart=inner["restart"], maxiter=inner["maxiter"],
                       rtol=inner["rtol"], precond=prob.spectral_precond),
        refinements=lsc["refinements"], rtol=lsc["rtol"])
    ec = cfg["eigensolver"]
    shift = ec["precond_shift"]
    eig = bk.LOBPCGEig(maxiter=ec["maxiter"], tol=ec["tol"],
                       extra=ec["extra"],
                       precond=lambda v: prob.spectral_precond(v,
                                                               shift=shift),
                       compute_dtype=DTYPES[ec["compute_dtype"]],
                       seed=seed)
    return ls, eig


class SHCell:
    """Set-up (model, Newton from the seeded guess, two warm-up points)
    and the jobs of the window."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.setup_parts = {}
        t = time.perf_counter()
        dtype = DTYPES[cfg["dtype"]]
        prob = models.swift_hohenberg_periodic_2d(
            Nx=cfg["Nx"], Ny=cfg["Ny"], lx=cfg["lx"], ly=cfg["ly"],
            l=cfg["l"], nu=cfg["nu"], dtype=dtype, operator=cfg["operator"],
            device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        amp = mix["seed"]["guess_perturbation"]
        guess = prob.u0 + amp * torch.randn(prob.u0.shape, generator=gen,
                                            dtype=dtype, device=device)
        eig_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                     device=device).item()) \
            if mix["seed"].get("eigensolver_start_block") else 7
        self.ls, self.eig = solvers(cfg, prob, eig_seed)
        ns = cfg["newton_setup"]
        sol = bk.newton(prob, bk.NewtonPar(tol=ns["tol"],
                                           max_iterations=ns["max_iterations"],
                                           linsolver=self.ls),
                        x0=guess)
        if not sol.converged:
            raise RuntimeError(f"set-up Newton did not converge "
                               f"(residual {float(sol.residuals[-1])})")
        self.prob = prob.re_make(u0=sol.u)
        self.params = prob.params
        self.setup_parts["model_newton_s"] = time.perf_counter() - t
        # two throwaway points: cuFFT plans, cuBLAS and cuSOLVER handles,
        # the kernel's library, at this cell's shapes
        t = time.perf_counter()
        self._continue(max_steps=2)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    def contparams(self, **over):
        c = dict(self.mix["continuation"])
        c.update(over)
        nb = self.cfg["newton_branch"]
        return bk.ContinuationPar(
            ds=c["ds"], dsmax=c["dsmax"], dsmin=c["dsmin"],
            p_min=c["p_min"], p_max=c["p_max"], max_steps=c["max_steps"],
            nev=c["nev"], detect_bifurcation=c["detect_bifurcation"],
            detect_fold=c["detect_fold"],
            save_eigenvectors=c["save_eigenvectors"],
            newton_options=bk.NewtonPar(tol=nb["tol"],
                                        max_iterations=nb["max_iterations"],
                                        linsolver=self.ls,
                                        eigsolver=self.eig))

    def _continue(self, hook=None, **over):
        return bk.continuation(self.prob, bk.PALC(), self.contparams(**over),
                               finalise_solution=hook)

    def job(self, index: int, hook):
        """One client's job: the branch from the set-up point."""
        self._continue(hook)

    # ------------------------------------------------------------------
    # what the harness hands the reference besides the window's points
    def theta(self) -> float:
        return float(bk.PALC().theta)

    def program_jv(self, u, p, v):
        """The program's J(u, p) v through the model's jac_op, as the
        window's Krylov and eigen solves apply it."""
        par = self.prob.set_lens_param(self.params, p)
        par = {k: (t.to(u.dtype) if isinstance(t, torch.Tensor) else t)
               for k, t in par.items()}
        return self.prob.jac_op(u, par)(v)

    def instrument(self):
        """Traced runs only: count the vectors that pass the model's jac_op
        boundary, by dtype and batch, so the bytes of the window's J.v
        products follow from the grid whatever implements them."""
        counts = {}
        inner = self.prob.jac_op

        def jac_op(u, par):
            op = inner(u, par)

            def counted(v):
                K = v.shape[0] if v.dim() == 3 else 1
                key = (str(v.dtype).split(".")[-1], K)
                counts[key] = counts.get(key, 0) + 1
                return op(v)

            return counted

        object.__setattr__(self.prob, "jac_op", jac_op)
        return counts


def build(cfg, mix, seed, device):
    return SHCell(cfg, mix, seed, device)
