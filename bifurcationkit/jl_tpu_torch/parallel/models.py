"""Rank-local problems for the sharded solver stack: each rank holds one
block of the state, and F and J.v exchange their halos explicitly
(`halo.py`), so that inside `use_mesh(mesh)` the solver stack runs the
JAX package's automatically sharded path (`__graft_entry__.py::
dryrun_multichip`, legs 1, 2, 4, 6 and 7) as rank-local code.

* `swift_hohenberg_2d_sharded`: the rows of `models.swift_hohenberg_2d`
  (Neumann), F and J.v through `sharded_sh_jv_local`, so on the card
  every product launches `sh_jv`'s halo closure;
* `brusselator_1d_sharded`: the sites of `models.brusselator_1d`, each
  rank's block the (u, v) pairs of its sites, through the model's own F,
  J.v and dF/dl with a one-site halo of both species, a batched form
  for the periodic orbits, and closed-form J^T.v, pairing gradient and
  parameter derivatives for the matrix-free codim-2 layer.

Both give their derivatives in closed form: forward or reverse AD through
a halo exchange would send a dual tensor.  Each carries `n_global`, the
whole state's size,
which the continuation kernels normalise by.  The spectral
preconditioners are not sharded (the JAX dry run runs plain GMRES for
the same reason).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import DEFAULT_DTYPE, resolve_device
from ..core.problem import BifurcationProblem
from ..core.state import global_norm
from ..models.equilibria import _brusselator_terms, brusselator_1d
from ..models.sh import _sh_d2F, _sh_d3F, swift_hohenberg_2d
from .halo import post_halo, sharded_sh_jv_local
from .mesh import local_block


def _record(x, p, **kwargs):
    return {"param": p, "norm": global_norm(x.reshape(-1))}


def _partitioned(prob: BifurcationProblem,
                 glob: BifurcationProblem) -> BifurcationProblem:
    """Mark `prob` (one rank's block of `glob`) as row-partitioned: the
    continuation kernels take the whole state's size from `n_global`
    and run inside `use_mesh` only."""
    object.__setattr__(prob, "n_global", int(glob.u0.numel()))
    return prob


def swift_hohenberg_2d_sharded(mesh: DeviceMesh, Nx: int = 151,
                               Ny: int = 100, lx: float = 8 * np.pi,
                               ly: float = 2 * 2 * np.pi / np.sqrt(3),
                               l: float = -0.1, nu: float = 1.3,
                               device=None,
                               dtype: torch.dtype = DEFAULT_DTYPE,
                               axis: str = "space") -> BifurcationProblem:
    """This rank's block of rows (`torch.chunk` over the ranks of `axis`)
    of `models.swift_hohenberg_2d(Nx, Ny, ...)`: u0 is the block of the
    model's guess, F = -(I+Delta)^2 u + l u + nu u^2 - u^3 with the linear
    part through the halo'd J.v at u = 0, and J.v through
    `sharded_sh_jv_local`."""
    dev = resolve_device(device)
    glob = swift_hohenberg_2d(Nx, Ny, lx, ly, l, nu, device=dev, dtype=dtype)
    hx, hy = 2 * lx / Nx, 2 * ly / Ny
    inv_h2 = torch.tensor([1.0 / float(hx * hx), 1.0 / float(hy * hy)],
                          dtype=torch.float64, device=dev)

    def scal(par, dt):
        lnu = torch.stack([torch.as_tensor(par["l"], dtype=dt, device=dev),
                           torch.as_tensor(par["nu"], dtype=dt, device=dev)])
        return torch.cat([lnu, inv_h2.to(dt)])

    def F(u, par):
        lin = torch.cat([inv_h2.new_zeros(2), inv_h2]).to(u.dtype)
        L1u = sharded_sh_jv_local(mesh, torch.zeros_like(u), u.contiguous(),
                                  lin, axis)
        return L1u + par["l"] * u + par["nu"] * u * u - u ** 3

    def jac_op(u, par):
        u_c, s = u.contiguous(), scal(par, u.dtype)
        return lambda v: sharded_sh_jv_local(mesh, u_c, v.contiguous(), s,
                                             axis)

    return _partitioned(BifurcationProblem(
        F, u0=local_block(mesh, glob.u0, axis, 0), params=glob.params,
        lens="l", jac_op=jac_op, d2F_user=_sh_d2F, d3F_user=_sh_d3F,
        dFdp_user=lambda u, par: u, record_from_solution=_record), glob)


def brusselator_1d_sharded(mesh: DeviceMesh, n: int = 100,
                           alpha: float = 2.0, beta: float = 5.45,
                           D1: float = 0.008, D2: float = 0.004,
                           l: float = 0.3, device=None,
                           dtype: torch.dtype = DEFAULT_DTYPE,
                           axis: str = "space",
                           batched: bool = False) -> BifurcationProblem:
    """This rank's sites (`torch.chunk` of the n sites over the ranks of
    `axis`) of `models.brusselator_1d(n, ...)`: its state is the flat
    [u_loc; v_loc] of its B sites, and F, J.v and dF/dl are the model's
    own (`_brusselator_terms`) with one site of u and v exchanged with
    each neighbour; the Dirichlet values enter at the global ends.

    `batched=True` marks F and J.v as taking a leading batch of rows,
    which cross in one halo exchange (the periodic orbits' batched route,
    as `brusselator_1d(batched=True)` on one device), and adds the closed
    form d2F, which is local.  Either form carries the closed-form hooks
    of what the matrix-free codim-2 layer and the trapezoid monodromy
    take by AD on one device: `jac_adjoint` (J^T.v, one halo exchange),
    `grad_pairing` (grad_x sum_k <w_k, J(x) v_k>, local) and
    `param_derivs` (dF/dp and d(J.v)/dp for the lenses l and beta)."""
    dev = resolve_device(device)
    glob = brusselator_1d(n, alpha, beta, D1, D2, l, device=dev, dtype=dtype,
                          batched=batched)
    u0 = local_block(mesh, glob.u0.reshape(2, n), axis, 1).reshape(-1)
    F, jac_op, dFdp, hooks = _brusselator_terms(
        u0.shape[0] // 2, 1.0 / n,
        halo=lambda x: post_halo(mesh, x, 1, axis).wait())
    prob = BifurcationProblem(
        F, u0=u0, params=glob.params, lens="l", jac_op=jac_op,
        jac_adjoint=hooks["jac_adjoint"], dFdp_user=dFdp,
        d2F_user=hooks["d2F"] if batched else None,
        record_from_solution=_record)
    for name in ("grad_pairing", "param_derivs"):
        object.__setattr__(prob, name, hooks[name])
    if batched:
        object.__setattr__(prob, "batched_F", True)
    return _partitioned(prob, glob)
