"""The builder of `brusselator_po_coll`: the port's batched 1-D Brusselator
at the Hopf point of its homogeneous branch, the Hopf normal form there, and
jobs of periodic-orbit continuation by collocation with the COP corrector
and FloquetColl, as the configuration file states them.

Set-up does not trace the equilibrium branch: Newton confirms the
homogeneous state at the configured Hopf parameter, a dense eig of the
jacobian gives the critical pair, and `hopf_normal_form_point` the normal
form that every job's predictor starts from.  The seed makes the one input
that differs between jobs, the predictor's parameter offset: every seed
runs the traffic file's offsets, each job the next of its permutation.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import bifurcationkit.jl_tpu_torch as bk
from bifurcationkit.jl_tpu_torch import models
from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import (
    hopf_normal_form_point, hopf_predictor)


class POCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.setup_parts = {}
        t = time.perf_counter()
        n = cfg["sites"]
        prob = models.brusselator_1d(
            n=n, alpha=cfg["alpha"], beta=cfg["beta"], D1=cfg["D1"],
            D2=cfg["D2"], l=cfg["hopf_l"], device=device, batched=True)
        ns = cfg["newton_setup"]
        sol = bk.newton(prob, bk.NewtonPar(
            tol=ns["tol"], max_iterations=ns["max_iterations"]))
        if not sol.converged:
            raise RuntimeError("set-up Newton at the Hopf parameter failed")
        J = prob.jacobian(sol.u, prob.params).detach().cpu().numpy()
        ev = np.linalg.eigvals(J)
        crit = ev[np.argmax(ev.real)]
        self.hp = hopf_normal_form_point(prob, sol.u, cfg["hopf_l"],
                                         abs(float(crit.imag)))
        self.prob, self.n = prob, 2 * n
        self.disc = bk.Collocation(Ntst=cfg["Ntst"], m=cfg["m"])
        offsets = list(mix["seed"]["predictor_offsets"])
        order = np.random.default_rng(seed).permutation(len(offsets))
        self.offsets = [offsets[i] for i in order]
        self.setup_parts["model_hopf_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._job(mix["warmup_offset"], None, max_steps=2)
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
            detect_fold=c["detect_fold"], tol_stability=c["tol_stability"],
            save_eigenvectors=c["save_eigenvectors"],
            newton_options=bk.NewtonPar(tol=nb["tol"],
                                        max_iterations=nb["max_iterations"],
                                        linsolver=bk.COPLS(),
                                        eigsolver=bk.FloquetColl()))

    def _job(self, offset, hook, **over):
        pred = hopf_predictor(self.hp, offset)
        X0 = self.disc.generate_solution(pred["orbit"], float(pred["period"]),
                                         self.n, device=self.device)
        params = self.prob.set_lens_param(self.prob.params, float(pred["p"]))
        return bk.continuation_po(
            self.prob, self.disc, X0, self.contparams(**over),
            alg=bk.PALC(bls=bk.COPBLS()), params=params, use_cop=True,
            floquet="coll", finalise_solution=hook)

    def job(self, index: int, hook):
        """One client's job: the orbits from the Hopf point's predictor
        at this job's offset."""
        self._job(self.offsets[index % len(self.offsets)], hook)

    def theta(self) -> float:
        return float(bk.PALC().theta)

    def instrument(self):
        return {}


def build(cfg, mix, seed, device):
    return POCell(cfg, mix, seed, device)
