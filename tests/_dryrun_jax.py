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


def _tshard(n):
    from bifurcationkit.jl_tpu.parallel import make_mesh

    tmesh = make_mesh((n,), ("time",), devices=jax.devices()[:n])
    return tmesh, NamedSharding(tmesh, P("time"))


def _shard_blocks(blocks, shardings):
    import dataclasses

    return dataclasses.replace(blocks, **{
        f: jax.device_put(getattr(blocks, f), s)
        for f, s in shardings.items()})


def jax_leg3(n=N_RANKS):
    """The JAX dry run's leg 3: the Stuart-Landau COP solve with the
    blocks on a ("time",) mesh of n devices, the unsharded `cop_solve`,
    and the monodromy tree product of the time-sharded interval maps.
    Here and in legs 5 and 6 the work the dry run runs eagerly is jitted
    (the same functions; eager JAX compiles every primitive)."""
    from bifurcationkit.jl_tpu import models
    from bifurcationkit.jl_tpu.periodic.cop import (
        collocation_block_jacobian, cop_solve)
    from bifurcationkit.jl_tpu.periodic.floquet import monodromy_from_maps
    from bifurcationkit.jl_tpu.periodic.orbits import periodic_orbit_problem

    tmesh, tshard = _tshard(n)
    prob = models.stuart_landau(r=0.5, mu=0.2, nu=0.5, c3=1.0, c5=0.0)
    disc = bk.Collocation(Ntst=2 * n, m=3)
    period = 2 * np.pi / abs(0.2 - 0.5 * 0.5)

    def orbit(t):
        return np.array([np.sqrt(0.5) * np.cos(-t),
                         np.sqrt(0.5) * np.sin(-t)])

    X0 = disc.generate_solution(orbit, period, 2)
    po = periodic_orbit_problem(prob, disc, X0)
    blocks = jax.jit(lambda X, par: collocation_block_jacobian(
        disc, prob, X, par))(X0, po.params)
    rhs = jnp.asarray(np.random.default_rng(0).standard_normal(X0.shape[0]))
    x_ref = jax.jit(cop_solve)(blocks, rhs)
    blocks_sh = _shard_blocks(blocks, {f: tshard for f in (
        "Aint", "B0", "cT", "phi0", "phiI")})
    with tmesh:
        x_sh = jax.jit(cop_solve)(blocks_sh, rhs)
        maps = disc.interval_maps(prob, X0, po.params)
        maps_sh = jax.device_put(maps, NamedSharding(tmesh,
                                                     P("time", None, None)))
        M = jax.jit(lambda m: monodromy_from_maps(m, method="assoc"))(
            maps_sh)
    return {"x": np.asarray(x_sh), "x_single": np.asarray(x_ref),
            "M": np.asarray(M)}


def jax_leg5(borders, n=N_RANKS):
    """The JAX dry run's leg 5 with the complex borders `borders` (the
    port's numpy draws, for both packages): the zero-Hopf PO by
    `newton_po`, the NS functional PO-MA jacobian, and `POMinAugLS` on
    its time-sharded blocks and on one device."""
    from bifurcationkit.jl_tpu.periodic.codim2 import (
        POMinAugLS, _po_ma_problem_functional)
    from bifurcationkit.jl_tpu.periodic.orbits import newton_po

    tmesh, tshard = _tshard(n)
    om = 1.5

    def F_zh(u, par):
        x, z = u[0], u[1] + 1j * u[2]
        zz = u[1] ** 2 + u[2] ** 2
        dx = par["p1"] + x * x - zz
        dz = ((par["p2"] + 1j * om) * z + (0.5 + 0.3j) * x * z
              + (-1.0 + 0.2j) * z * zz)
        return jnp.array([dx, jnp.real(dz), jnp.imag(dz)])

    prob = bk.BifurcationProblem(F_zh, u0=jnp.zeros(3),
                                 params={"p1": 0.02488, "p2": 0.012766},
                                 lens="p1")
    disc = bk.Collocation(Ntst=2 * n, m=4)
    r5 = np.sqrt(2.0) * 0.08

    def orbit(t):
        return np.array([r5 * r5, r5 * np.cos(t), r5 * np.sin(t)])

    X0 = disc.generate_solution(orbit, 2 * np.pi / om, 3)
    sol, po = newton_po(prob, disc, X0,
                        options=bk.NewtonPar(tol=1e-9, max_iterations=30))
    maprob, _ = _po_ma_problem_functional(po, "p2", "ns")
    params = dict(po.params)
    params["_a"], params["_b"] = (jnp.asarray(b) for b in borders)
    Y = jnp.concatenate([sol.u, jnp.asarray([0.02488, 0.48])])
    jac = jax.jit(maprob.jac)(Y, params)
    rhs = jnp.asarray(np.random.default_rng(9).standard_normal(Y.shape[0]))
    ls = POMinAugLS()
    x_ref, _, _ = jax.jit(lambda j, r: ls(j, r))(jac, rhs)
    import dataclasses

    jac_sh = dataclasses.replace(jac, blocks=_shard_blocks(
        jac.blocks, {f: tshard for f in ("Aint", "B0", "cT", "phi0",
                                         "phiI")}))
    with tmesh:
        x_sh, _, _ = jax.jit(lambda j, r: ls(j, r))(jac_sh, rhs)
    return {"x": np.asarray(x_sh), "x_single": np.asarray(x_ref),
            "u_po": np.asarray(sol.u), "converged": bool(sol.converged)}


def jax_leg6(nt, ns):
    """The JAX dry run's leg 6 on an (nt, ns) ("time", "space") mesh of
    nt ns devices: the Brusselator PO's COP solve with the blocks placed
    over both axes, and the trapezoid monodromy apply on v sharded over
    `space`; with the unsharded solve and apply."""
    from bifurcationkit.jl_tpu import models
    from bifurcationkit.jl_tpu.parallel import make_mesh
    from bifurcationkit.jl_tpu.periodic.cop import (
        collocation_block_jacobian, cop_solve)
    from bifurcationkit.jl_tpu.periodic.orbits import periodic_orbit_problem

    mesh2 = make_mesh((nt, ns), ("time", "space"),
                      devices=jax.devices()[:nt * ns])
    n_sites = 4 * ns
    vf = models.brusselator_1d(n=n_sites)
    n6 = 2 * n_sites
    disc = bk.Collocation(Ntst=2 * nt, m=3)
    base = np.asarray(vf.u0)

    def orbit(t):
        return base + 0.05 * np.cos(t) * np.sin(
            np.pi * (np.arange(n6) + 1) / (n6 + 1))

    X0 = disc.generate_solution(orbit, 5.0, n6)
    po = periodic_orbit_problem(vf, disc, X0)
    blocks = jax.jit(lambda X, par: collocation_block_jacobian(
        disc, vf, X, par))(X0, po.params)
    rhs = jnp.asarray(np.random.default_rng(6).standard_normal(X0.shape[0]))
    x_ref = jax.jit(cop_solve)(blocks, rhs)
    ts2 = NamedSharding(mesh2, P("time", "space", None))
    blocks_sh = _shard_blocks(blocks, {
        "Aint": ts2, "B0": ts2,
        "cT": NamedSharding(mesh2, P("time", "space")),
        "phi0": NamedSharding(mesh2, P("time", None)),
        "phiI": NamedSharding(mesh2, P("time", "space"))})
    with mesh2:
        x_sh = jax.jit(cop_solve)(blocks_sh, rhs)
    trap = bk.Trapeze(M=4 * nt)
    Xt = trap.generate_solution(orbit, 5.0, n6)
    pot = periodic_orbit_problem(vf, trap, Xt)
    op = trap.monodromy_operator(vf, Xt, pot.params)
    v = jnp.asarray(np.random.default_rng(7).standard_normal(n6))
    ref_apply = jax.jit(op)(v)
    with mesh2:
        out = jax.jit(op)(jax.device_put(v, NamedSharding(mesh2,
                                                          P("space"))))
    return {"x": np.asarray(x_sh), "x_single": np.asarray(x_ref),
            "monodromy_apply": np.asarray(out),
            "monodromy_apply_single": np.asarray(ref_apply)}


def jax_leg7(n=N_RANKS):
    """The JAX dry run's leg 7 on a 1 x n ("branch", "space") mesh: the
    fold MA sigma system's anchors and one Govaerts apply, the flat
    vectors sharded over `space`; with the unsharded ones."""
    from bifurcationkit.jl_tpu import models
    from bifurcationkit.jl_tpu.codim2.minaug_mf import fold_ma_problem_mf
    from bifurcationkit.jl_tpu.parallel import make_mesh

    mesh = make_mesh((1, n), ("branch", "space"), devices=jax.devices()[:n])
    vf = models.brusselator_1d(n=8 * n)
    n7 = 2 * 8 * n
    ma = fold_ma_problem_mf(vf, vf.lens, "beta")
    rng = np.random.default_rng(11)
    x = jnp.asarray(np.asarray(vf.u0).ravel()
                    + 0.05 * rng.standard_normal(n7))
    p1 = jnp.asarray(0.31)
    a = jnp.asarray(rng.standard_normal(n7))
    a = a / jnp.linalg.norm(a)
    dx = jnp.asarray(rng.standard_normal(n7))
    dp = jnp.asarray(0.7)

    @jax.jit
    def sigma_leg(x, p1s, a, b):
        X = jnp.concatenate([x, p1s[None]])
        return ma.anchors_kernel(X, {**ma.params, "_a": a, "_b": b})

    @jax.jit
    def gov_apply_leg(x, p1s, a, b, dx, dp):
        X = jnp.concatenate([x, p1s[None]])
        d = jnp.concatenate([dx, dp[None]])
        return ma.jac_op(X, {**ma.params, "_a": a, "_b": b})(d)

    v_ref, w_ref, sig_ref = sigma_leg(x, p1, a, a)
    ap_ref = gov_apply_leg(x, p1, a, a, dx, dp)
    with mesh:
        sh = NamedSharding(mesh, P("space"))
        xs, as_, dxs = (jax.device_put(t, sh) for t in (x, a, dx))
        v, w, sig = sigma_leg(xs, p1, as_, as_)
        ap = gov_apply_leg(xs, p1, as_, as_, dxs, dp)
    return {"v": np.asarray(v), "w": np.asarray(w), "sigma": float(sig),
            "apply": np.asarray(ap), "v_single": np.asarray(v_ref),
            "w_single": np.asarray(w_ref), "sigma_single": float(sig_ref),
            "apply_single": np.asarray(ap_ref)}
