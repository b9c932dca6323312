"""The measured window: jobs of the system under test, one after another
from the point set-up converged, each point stamped through the public
`finalise_solution` hook of `continuation`.

A job is one `continuation` call.  It runs until the traffic's settings
end it (`p_min`, `p_max`, `max_steps`); the next job then starts from the
set-up point again: a closed loop with one client.  The time charged to a
point runs from the previous point of its job, or from the start of its
job, so a job's start-up (two Newtons and the tangent) and any bisection
are charged to the point that paid for them.  The hook returns False once
the window's time is up, which ends the branch; the window ends at the
stamp of that last point, on a `torch.cuda.synchronize()`.
"""
from __future__ import annotations

import gc
import time
import traceback

import numpy as np
import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    """Runs `cell.job(index, hook)` until `seconds` have passed and keeps
    what each point's hook saw (the program's outputs, held as they are;
    nothing is copied inside the window but the host's scalars)."""

    def __init__(self, cell, seconds: float, device, trace=None,
                 max_points: int = None):
        self.cell, self.seconds, self.device = cell, seconds, device
        self.trace = trace
        self.max_points = max_points
        self.points = []
        self.jobs = []           # (job index, start stamp, error or None)
        self.t_start = self.t_end = None

    # ------------------------------------------------------------------
    def _hook_for(self, job: int, t_job: float):
        seen = {"sp": 0, "last": t_job, "k": 0}

        def hook(z, tau, step, res, state=None, **_):
            _sync(self.device)
            now = time.perf_counter()
            sps = res.specialpoint
            new = [sp for sp in sps[seen["sp"]:]]
            seen["sp"] = len(sps)
            here = [sp for sp in new if sp.step == step
                    and sp.type not in ("fold", "endpoint")]
            self.points.append(dict(
                job=job, k=seen["k"], t=now, dt=now - seen["last"],
                u=z.u, p=float(z.p), tau_u=tau.u, tau_p=float(tau.p),
                ds=float(state.ds), step=int(step),
                itnewton=int(state.itnewton), itlinear=int(state.itlinear),
                res=float(state.res),
                eigvals=None if state.eigvals is None
                else np.array(state.eigvals),
                n_unstable=tuple(state.n_unstable),
                n_imag=tuple(state.n_imag),
                special=[dict(type=sp.type, param=float(sp.param),
                              status=sp.status, x=sp.x,
                              eigvals=None if sp.eigenvals is None
                              else np.array(sp.eigenvals))
                         for sp in here]))
            seen["last"] = now
            seen["k"] += 1
            i = len(self.points) - 1
            if self.trace is not None:
                self.trace.on_point(i)
            done = now - self.t_start >= self.seconds or (
                self.max_points is not None and i + 1 >= self.max_points)
            if done:
                self.t_end = now
                return False
            return True

        return hook

    def run(self):
        # set-up's objects are long-lived: moved out of the collector's
        # way, so that a full collection of them does not land in the window
        gc.collect()
        gc.freeze()
        _sync(self.device)
        self.t_start = time.perf_counter()
        job = 0
        while self.t_end is None:
            _sync(self.device)
            t_job = time.perf_counter()
            err = None
            try:
                self.cell.job(job, self._hook_for(job, t_job))
            except Exception:            # a job that raises is a failure
                err = traceback.format_exc(limit=8)
            self.jobs.append((job, t_job, err))
            job += 1
            if self.t_end is None and err is not None:
                _sync(self.device)
                now = time.perf_counter()
                if now - self.t_start >= self.seconds:
                    self.t_end = now
        if self.trace is not None:
            self.trace.close()
        gc.unfreeze()
        return self

    # ------------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def failed(self) -> int:
        return sum(1 for _, _, e in self.jobs if e is not None)

    @property
    def attempted(self) -> int:
        return len(self.points) + self.failed
