"""The JAX side of the dry-run tests (`test_torch_parallel_dryrun*.py`):
the legs of `__graft_entry__.py::dryrun_multichip` run by the JAX package
on 2 devices of the conftest's CPU mesh, the state sharded as the dry run
shards it, and the spawn of the port's ranks that the tests hold them
against."""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import bifurcationkit.jl_tpu as bk
from bifurcationkit.jl_tpu_torch.parallel import dryrun
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks

N_RANKS, ROWS = 2, 24


def spawn_ranks():
    """The port's dry run on N_RANKS gloo ranks, leg 4 at ROWS x 100."""
    return start_ranks(
        "bifurcationkit.jl_tpu_torch.parallel.dryrun:dryrun_multichip",
        N_RANKS, dict(n_ranks=N_RANKS, device="cpu", flagship_rows=ROWS),
        timeout=90)


def jax_mesh():
    from bifurcationkit.jl_tpu.parallel import make_mesh

    return make_mesh((1, N_RANKS), ("branch", "space"),
                     devices=jax.devices()[:N_RANKS])


def jax_leg1(mesh):
    """The JAX dry run's leg 1 on `mesh`, and the secant corrector."""
    from bifurcationkit.jl_tpu import models
    from bifurcationkit.jl_tpu.continuation.engine import ContIterable
    from bifurcationkit.jl_tpu.core.state import BorderedState, tree_axpy

    n_sites = 8 * N_RANKS
    prob = models.brusselator_1d(n=n_sites)
    cp = bk.ContinuationPar(
        ds=1e-2, dsmax=5e-2, dsmin=1e-7, p_min=0.25, p_max=0.8, max_steps=3,
        detect_bifurcation=0, detect_fold=False,
        newton_options=bk.NewtonPar(
            tol=1e-8, max_iterations=12,
            linsolver=bk.GMRES(restart=160, maxiter=320, rtol=1e-10)))
    kn = ContIterable(prob, bk.PALC(), cp).kernels
    sharding = NamedSharding(mesh, P("space"))
    u0 = jax.device_put(
        prob.u0 + 1e-2 * jnp.sin(jnp.arange(2 * n_sites) * 0.1), sharding)
    w = jax.device_put(jnp.asarray(dryrun.leg1_secant_direction(n_sites)),
                       sharding)
    p0, ds = jnp.asarray(0.3), jnp.asarray(1e-3)
    with mesh:
        u_conv, cv, itn, _, _ = kn.newton_fixed(u0, p0, prob.params)
        z = BorderedState(u=u_conv, p=p0)
        tau = BorderedState(u=jnp.zeros_like(u_conv),
                            p=jnp.asarray(1.0 / np.sqrt(0.5)))
        z_pred = BorderedState(u=tree_axpy(ds, tau.u, z.u),
                               p=z.p + ds * tau.p)
        z_new = kn.palc_corrector(z_pred, z, tau, ds, prob.params)[0]
        z_b = BorderedState(u=tree_axpy(1e-2, w, u_conv),
                            p=jnp.asarray(0.3 + 1e-2))
        tau_s = kn.secant_tangent(z_b, z, ds)
        z_pred = BorderedState(u=tree_axpy(ds, tau_s.u, z.u),
                               p=z.p + ds * tau_s.p)
        z_sec = kn.palc_corrector(z_pred, z, tau_s, ds, prob.params)[0]
    return {"newton_it": int(itn), "u_newton": np.asarray(u_conv),
            "palc_p": float(z_new.p), "u_palc": np.asarray(z_new.u),
            "secant_p": float(z_sec.p), "u_secant": np.asarray(z_sec.u),
            "secant_tau_p": float(tau_s.p),
            "tau_u_secant": np.asarray(tau_s.u)}


def _sh_leg(mesh, rows, cols, cp, n_steps):
    """The JAX dry run's legs 2 and 4: SH2d on the trivial branch, the
    state sharded by rows, n_steps continuation steps with detection."""
    from bifurcationkit.jl_tpu import models
    from bifurcationkit.jl_tpu.continuation.engine import ContIterable

    sh = models.swift_hohenberg_2d(Nx=rows, Ny=cols)
    u0 = jax.device_put(jnp.zeros_like(sh.u0),
                        NamedSharding(mesh, P("space", None)))
    it = ContIterable(sh.re_make(u0=u0), bk.PALC(), cp)
    counts = []
    with mesh:
        state = it.init_state()
        counts.append(int(state.n_unstable[0]))
        for _ in range(n_steps):
            it.iterate(state)
            counts.append(int(state.n_unstable[0]))
    return {"converged": bool(state.converged), "p": float(state.p),
            "n_unstable": counts}


def _sh_contpar(max_steps, krylov_dim, restarts, tol_eig, restart,
                    maxiter, max_it):
    eig = bk.ArnoldiEig(which="LR", krylov_dim=krylov_dim,
                        restarts=restarts, tol=tol_eig,
                        compute_dtype=np.float32)
    return bk.ContinuationPar(
        ds=-5e-3, dsmax=2e-2, dsmin=1e-7, p_min=-0.8, p_max=0.2,
        max_steps=max_steps, nev=4, detect_bifurcation=3, detect_fold=True,
        newton_options=bk.NewtonPar(
            tol=1e-6, max_iterations=max_it,
            linsolver=bk.GMRES(restart=restart, maxiter=maxiter, rtol=1e-8),
            eigsolver=eig))


def jax_leg2(mesh):
    """Leg 2: SH2d at (4 N_RANKS) x 12, 3 steps."""
    return _sh_leg(mesh, 4 * N_RANKS, 12,
                   _sh_contpar(3, 16, 2, 1e-3, 80, 400, 12), 3)


def jax_leg4(mesh):
    """Leg 4 with its 152 rows cut to ROWS, 1 step."""
    return _sh_leg(mesh, ROWS, dryrun.FLAGSHIP_COLS,
                   _sh_contpar(1, 12, 1, 1e-2, 40, 80, 8), 1)
