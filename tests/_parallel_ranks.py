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
