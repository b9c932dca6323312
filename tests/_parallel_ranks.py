"""Rank-side halves of `test_torch_parallel.py` and
`test_torch_parallel_dryrun.py`: run inside the gloo ranks that
`parallel.launch` spawns, import the port only (no JAX), and return numpy
results."""
import numpy as np
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix
from bifurcationkit.jl_tpu_torch.parallel import (full_state, make_mesh,
                                                  pdot, sharded_dia_spmv,
                                                  sharded_monodromy,
                                                  use_mesh)
from bifurcationkit.jl_tpu_torch.parallel.halo import sharded_sh_jv
from bifurcationkit.jl_tpu_torch.parallel.models import \
    brusselator_1d_sharded
from bifurcationkit.jl_tpu_torch.parallel.ops import sh_residual_2d

N_RANKS = 4


def _np(x, mesh):
    return full_state(x, mesh).cpu().numpy()


def dia_data(seed: int, n: int, offsets):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n))
    for k, off in enumerate(offsets):
        if off > 0:
            data[k, n - off:] = 0
        elif off < 0:
            data[k, :-off] = 0
    return data, rng.standard_normal(n)


def brusselator_guess(n_sites: int) -> np.ndarray:
    u0 = np.concatenate([np.full(n_sites, 2.0), np.full(n_sites, 5.45 / 2)])
    return u0 + 1e-2 * np.sin(np.arange(2 * n_sites) * 0.1)


def newton_options():
    return bt.NewtonPar(tol=1e-8, max_iterations=12,
                        linsolver=bt.GMRES(restart=160, maxiter=320,
                                           rtol=1e-10))


def stencil_field():
    return np.random.default_rng(9).standard_normal((16, 12))


def bordered_gmres(mesh, prob, u_loc, n_sites):
    """MatrixFreeBLS (GMRES on the raveled BorderedState [u; p], whose p
    is the same on every rank) at the sharded Newton's solution, against
    the same solve on one device: solutions and iteration counts.  The
    shift makes the bordered operator well conditioned, so GMRES stops
    early (12 iterations at rtol 1e-4), where an inner product that
    counted p once per rank would leave another iterate."""
    rng = np.random.default_rng(11)
    dzu, R = rng.standard_normal((2, 2 * n_sites))
    shift = 3000.0
    bls = bt.MatrixFreeBLS(bt.GMRES(restart=160, maxiter=320, rtol=1e-4))
    par = prob.params
    u_glob = full_state(u_loc.reshape(2, -1), mesh, dim=1).reshape(-1)
    one = bt.models.brusselator_1d(n=n_sites, device="cpu", batched=True)
    x1, p1, cv1, it1 = bls(one.jacobian_operator(u_glob, par),
                           one.dFdp(u_glob, par), torch.tensor(dzu), 0.7,
                           torch.tensor(R), 0.3, 0.5, 0.5, shift)

    def put(x):
        return interop.state_to_mesh(x.reshape(2, -1), mesh,
                                     dim=1).reshape(-1)

    with use_mesh(mesh):
        x, p, cv, it = bls(prob.jacobian_operator(u_loc, par),
                           prob.dFdp(u_loc, par), put(dzu), 0.7, put(R),
                           0.3, 0.5, 0.5, shift)
    return {"bls_u": full_state(x.reshape(2, -1), mesh,
                                dim=1).reshape(-1).numpy(),
            "bls_p": float(p), "bls_converged": bool(cv), "bls_it": int(it),
            "bls_u_single": x1.numpy(), "bls_p_single": float(p1),
            "bls_it_single": int(it1)}


def cases(sh_u, sh_v, sh_scal, maps):
    """The six cases of test_parallel.py on the ranks of the group, and the
    roll-based SH residual (parallel/ops.py) on a row-sharded DTensor."""
    mesh = make_mesh((1, N_RANKS), ("branch", "space"), device="cpu")
    out = {}
    # sharded DIA SpMV (plain global input), against the single-device one
    offsets = (-3, -1, 0, 1, 3)
    data, v = dia_data(0, 8 * 64, offsets)
    A = DIAMatrix(torch.tensor(data), offsets)
    out["dia"] = _np(sharded_dia_spmv(mesh, A, torch.tensor(v)), mesh)
    out["dia_ref"] = A.matvec(torch.tensor(v)).numpy()
    # the same with an input sharded over the mesh
    rng = np.random.default_rng(1)
    n = 8 * 32
    A2 = DIAMatrix(torch.tensor(rng.standard_normal((3, n))), (-1, 0, 1))
    v2 = rng.standard_normal(n)
    out["dia_sharded_in"] = _np(sharded_dia_spmv(
        mesh, A2, interop.state_to_mesh(v2, mesh, dtensor=True)), mesh)
    out["dia_sharded_in_ref"] = A2.matvec(torch.tensor(v2)).numpy()
    # pdot over the ranks' blocks
    x = interop.state_to_mesh(np.arange(8 * 16, dtype=np.float64), mesh)
    with use_mesh(mesh):
        out["pdot"] = float(pdot(x, torch.ones_like(x)))
    # sharded Newton-GMRES on the Brusselator
    n_sites = 8 * 8
    prob = brusselator_1d_sharded(mesh, n=n_sites, device="cpu")
    u0 = interop.state_to_mesh(brusselator_guess(n_sites).reshape(2, -1),
                               mesh, dim=1).reshape(-1)
    with use_mesh(mesh):
        sol = bt.newton(prob.re_make(u0=u0), newton_options())
    blocks = full_state(sol.u.reshape(2, -1), mesh, dim=1)
    out["newton_converged"] = bool(sol.converged)
    out["newton_it"] = int(sol.itnewton)
    out["newton_u"] = blocks.reshape(-1).numpy()
    out.update(bordered_gmres(mesh, prob, sol.u, n_sites))
    # row-partitioned SH J.v
    out["sh_jv"] = _np(sharded_sh_jv(
        mesh, interop.state_to_mesh(sh_u, mesh, dtensor=True),
        interop.state_to_mesh(sh_v, mesh, dtensor=True),
        torch.tensor(sh_scal)), mesh)
    # time-sharded monodromy product
    out["monodromy"] = sharded_monodromy(interop.state_to_mesh(maps, mesh),
                                         mesh).numpy()
    # the roll-based residual on a DTensor sharded by rows
    res = sh_residual_2d(
        interop.state_to_mesh(stencil_field(), mesh, dtensor=True),
        {"l": -0.1, "nu": 1.3}, 0.3, 0.4)
    out["sh_residual"] = res.full_tensor().numpy()
    out["sh_residual_placements"] = str(res.placements)
    return out


# ---------------------------------------------------------------------------
# dry-run legs 3 and 5-7, the time-sharded COP solves, block GMRES, the
# replicated tail and the sharded Brusselator's hooks
# (test_torch_parallel_cop.py, _leg5.py, _leg6.py, _leg7.py, _gmres.py)
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")


def cop_borders(size: int):
    """Seeded borders of the bordered and k-border COP solves: dR, dzu,
    the k = 2 columns C (size, 2), rows D (2, size), E (2, 2) and s (2,)."""
    rng = np.random.default_rng(21)
    return {"dR": rng.standard_normal(size), "dzu": rng.standard_normal(size),
            "C": rng.standard_normal((size, 2)),
            "D": rng.standard_normal((2, size)),
            "E": rng.standard_normal((2, 2)), "s": rng.standard_normal(2)}


def cop_legs(n_ranks: int):
    """Leg 3, and the bordered and k-border time-sharded COP solves of
    leg 3's block jacobian, on a ("time",) mesh of the ranks."""
    from bifurcationkit.jl_tpu_torch.parallel import cop as pcop
    from bifurcationkit.jl_tpu_torch.parallel import dryrun

    tmesh = make_mesh((n_ranks,), ("time",), device="cpu")
    out = {"leg3": dryrun.leg3_cop(tmesh, CPU, n_ranks)}
    blocks, rhs = dryrun._stuart_landau_cop(CPU, n_ranks)
    sh = pcop.shard_blocks(blocks, tmesh)
    b = {k: torch.tensor(v) for k, v in cop_borders(rhs.shape[0]).items()}
    x, dp = pcop.cop_solve_bordered_sharded(sh, rhs, 0.3, b["dR"], b["dzu"],
                                            0.7, 0.5, 0.6, 0.9)
    out["bordered"] = (x.numpy(), float(dp))
    x, y = pcop.cop_solve_block_sharded(sh, rhs, b["C"], b["D"], b["E"],
                                        b["s"])
    out["block"] = (x.numpy(), y.numpy())
    return out


def leg5(n_ranks: int):
    from bifurcationkit.jl_tpu_torch.parallel import dryrun

    tmesh = make_mesh((n_ranks,), ("time",), device="cpu")
    return dryrun.leg5_po_ma(tmesh, CPU, n_ranks)


def leg6(nt: int, ns: int):
    from bifurcationkit.jl_tpu_torch.parallel import dryrun

    return dryrun.dryrun_mesh2d(nt, ns, "cpu")["leg6"]


def leg7(n_ranks: int):
    from bifurcationkit.jl_tpu_torch.parallel import dryrun

    mesh = make_mesh((1, n_ranks), ("branch", "space"), device="cpu")
    return dryrun.leg7_fold_mf(mesh, CPU, n_ranks)


GMRES_SITES = 16


def block_gmres_case():
    """The columns, the operator and the solver of the block-GMRES case:
    the Brusselator's implicit trapezoid step W - c J(x) W at a seeded
    state, on 5 columns: three seeded, one zero (frozen from the start)
    and one 1e3 times larger; restart 6 so that the columns restart and
    freeze at different iterations."""
    rng = np.random.default_rng(31)
    x = brusselator_guess(GMRES_SITES) + 0.1 * rng.standard_normal(
        2 * GMRES_SITES)
    B = rng.standard_normal((5, 2 * GMRES_SITES))
    B[3] = 0.0
    B[4] *= 1e3
    return x, B, 0.02, bt.GMRES(restart=6, maxiter=60, rtol=1e-9)


def tail_case():
    """The extended system [J - 200 I, a; a^T 0][v; s] = [0; 1] at a
    seeded state, whose scalar s is the replicated tail: the shift makes
    GMRES stop early at rtol 1e-3 (8 iterations of 33), where a tail
    counted once per rank would change the iterate."""
    rng = np.random.default_rng(41)
    x = brusselator_guess(GMRES_SITES) + 0.1 * rng.standard_normal(
        2 * GMRES_SITES)
    a = rng.standard_normal(2 * GMRES_SITES)
    return x, a / np.linalg.norm(a), 200.0, dict(restart=40, maxiter=240,
                                                 rtol=1e-3, atol=0.0)


def hook_inputs():
    """A state, a batch of 3 rows, directions v, w and the parameters at
    which the sharded Brusselator's hooks are held to torch.func."""
    rng = np.random.default_rng(51)
    n = 2 * GMRES_SITES
    return (brusselator_guess(GMRES_SITES) + 0.1 * rng.standard_normal(n),
            rng.standard_normal((3, n)), rng.standard_normal((2, n)))


def gmres_and_hooks(n_ranks: int):
    """Block GMRES and the replicated tail under `use_mesh`, and the
    sharded Brusselator's hooks, on a 1 x n_ranks mesh: results in the
    global layout."""
    mesh = make_mesh((1, n_ranks), ("branch", "space"), device="cpu")
    prob = brusselator_1d_sharded(mesh, n=GMRES_SITES, device="cpu",
                                  batched=True)
    par = prob.params

    def put(y):
        y = np.asarray(y)
        return interop.state_to_mesh(
            y.reshape(y.shape[:-1] + (2, GMRES_SITES)), mesh,
            dim=y.ndim).reshape(y.shape[:-1] + (-1,))

    def glob(y):
        return full_state(y.reshape(y.shape[:-1] + (2, -1)), mesh,
                          dim=y.dim()).reshape(y.shape[:-1] + (-1,)).numpy()

    out = {}
    x, B, c, gm = block_gmres_case()
    J = prob.jac_op(put(x), par)
    with use_mesh(mesh):
        X, cv, it = gm.solve_block(lambda W: W - c * J(W), put(B))
    out["block"] = (glob(X), np.asarray(cv), np.asarray(it))
    x, a, shift, opts = tail_case()
    gm = bt.GMRES(n_rep=1, **opts)
    J = prob.jac_op(put(x), par)
    with use_mesh(mesh):
        z, cv, it = gm(bordered_operator(lambda v: J(v) - shift * v,
                                         put(a)), bordered_rhs(put(a)))
    out["tail"] = (glob(z[:-1]), float(z[-1]), bool(cv), int(it))
    x, rows, vw = hook_inputs()
    xs, r = put(x), put(rows)
    v, w = put(vw[0]), put(vw[1])
    out["F_batch"] = glob(prob.F(r, par))
    out["jv_batch"] = glob(prob.jac_op(xs, par)(r))
    out["jac_adjoint"] = glob(prob.jac_adjoint(xs, par)(w))
    out["grad_pairing"] = glob(prob.grad_pairing(xs, par, [v, w], [w, v]))
    out["d2F"] = glob(prob.d2F_user(xs, par, v, w))
    for name, (dF, dJv) in prob.param_derivs.items():
        out[f"dF_d{name}"] = glob(dF(xs, par))
        out[f"dJv_d{name}"] = glob(dJv(xs, par, v))
    return out


def bordered_operator(Jd, a):
    """z = [v; s] -> [J v + s a; <a, v>]: the extended fold system, its
    border dot completed over the ranks inside `use_mesh`."""
    from bifurcationkit.jl_tpu_torch.core.state import global_dot

    def op(z):
        return torch.cat([Jd(z[:-1]) + z[-1] * a,
                          global_dot(a, z[:-1]).reshape(1)])

    return op


def bordered_rhs(a):
    return torch.cat([torch.zeros_like(a), torch.ones(1, dtype=a.dtype)])


def rel(a, b) -> float:
    """||a - b|| / ||b|| (the dry run's relative error)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))
