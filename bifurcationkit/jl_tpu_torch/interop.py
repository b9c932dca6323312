"""Carry problem data and results between the JAX package and the port as
numpy arrays, so both compute from the same `u0` / `params` and their
branches can be compared column by column.  Nothing here imports JAX: the
JAX side hands over numpy arrays and plain Python numbers."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import DEFAULT_DTYPE
from .parallel.mesh import local_block, shard_state


def state_from_numpy(u, params: Dict[str, Any], device,
                     dtype: torch.dtype = DEFAULT_DTYPE
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(u, params) as the port's tensors on `device`: u as given, each
    parameter as a 0-d tensor."""
    dev = torch.device(device)
    u_t = torch.tensor(np.asarray(u), dtype=dtype, device=dev)
    par_t = {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev)
             for k, v in params.items()}
    return u_t, par_t


def state_to_mesh(u, mesh, axis: str = "space", dim: int = 0,
                  dtensor: bool = False,
                  dtype: torch.dtype = DEFAULT_DTYPE):
    """A global state handed over as numpy (the JAX package's array, the
    same on every rank) placed on a device mesh (`parallel.make_mesh`):
    this rank's block along `dim` over the ranks of `axis` (`torch.chunk`,
    as a DTensor's `Shard(dim)` splits) on the mesh's device, or with
    `dtensor=True` the DTensor sharded so (`parallel.shard_state`)."""
    t = torch.tensor(np.asarray(u), dtype=dtype,
                     device=torch.device(mesh.device_type))
    if dtensor:
        return shard_state(mesh, t, axis, dim)
    return local_block(mesh, t, axis, dim)


def state_to_numpy(u: torch.Tensor, params: Dict[str, Any]
                   ) -> Tuple[np.ndarray, Dict[str, float]]:
    """The inverse of `state_from_numpy`: u as a numpy array, each
    parameter as a Python float."""
    return (u.detach().cpu().numpy(),
            {k: float(v) for k, v in params.items()})


def branch_to_numpy(br) -> Dict[str, np.ndarray]:
    """The comparable columns of a `ContResult` of either package:
    per-step `p`, `n_unstable`, `stable`, and the special points' `type`
    and `p` (in detection order)."""
    return {
        "p": np.asarray(br.param, dtype=float),
        "n_unstable": np.asarray(br.n_unstable, dtype=int),
        "stable": np.asarray(br.stable, dtype=bool),
        "sp_type": np.asarray([sp.type for sp in br.specialpoint], dtype=str),
        "sp_p": np.asarray([float(sp.param) for sp in br.specialpoint],
                           dtype=float),
    }


def _to_numpy(a):
    """A tensor, an array of either package or a number as numpy; lists
    (the Nd kernel bases) stack as columns."""
    if isinstance(a, (list, tuple)):
        return np.stack([_to_numpy(x) for x in a], axis=1)
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def normal_form_to_numpy(nf) -> Dict[str, Any]:
    """A normal-form point of either package (`Pitchfork`, `Hopf`,
    `NdBranchPoint`, ...) as numpy: its type name `kind`, the `nf` dict's
    scalars (Python numbers, complex for Hopf) and arrays, `zeta`,
    `zeta_star`, `p` and, for Hopf points, `omega`."""
    coef = {}
    for k, v in nf.nf.items():
        arr = _to_numpy(v)
        coef[k] = arr.item() if arr.ndim == 0 else arr
    out = {"kind": type(nf).__name__, "nf": coef, "zeta": _to_numpy(nf.zeta),
           "zeta_star": _to_numpy(nf.zeta_star), "p": float(nf.p)}
    if hasattr(nf, "omega"):
        out["omega"] = float(nf.omega)
    return out


def codim2_branch_to_numpy(br) -> Dict[str, np.ndarray]:
    """The comparable columns of a codim-2 curve (a `Branch` or its
    `ContResult`, of either package): the continuation parameter `param`,
    the codim-1 parameter `p1`, `omega` on Hopf curves, and the special
    points' `type`, `param` and `status` (in detection order)."""
    gamma = getattr(br, "gamma", br)
    tbl = gamma._table()
    out = {k: np.asarray(tbl[k], dtype=float)
           for k in ("param", "p1", "omega") if k in tbl}
    sps = gamma.specialpoint
    out["sp_type"] = np.asarray([sp.type for sp in sps], dtype=str)
    out["sp_param"] = np.asarray([float(sp.param) for sp in sps], dtype=float)
    out["sp_status"] = np.asarray([sp.status for sp in sps], dtype=str)
    return out


def po_params_from_numpy(po_par: Dict[str, Any], device,
                         dtype: torch.dtype = DEFAULT_DTYPE
                         ) -> Dict[str, Any]:
    """A periodic-orbit problem's parameters handed over as numpy, as the
    port's: the vector field's parameters under `_inner` as 0-d tensors,
    every other entry as a tensor.  That covers each discretization's
    data: the trapezoid's reference orbit `_uref` and phase gradient
    `_phi` ((M, n) each); collocation's reference nodes `_uref`
    ((Ntst m + 1, n)), phase gradient at the Gauss points `_phi`
    ((Ntst, m, n)) and mesh `_mesh` ((Ntst + 1,)); standard shooting's
    section point `_xsec` and normal `_phisec` ((n,) each); Poincare
    shooting's section centers `_centers` and normals `_normals` ((M, n)
    each) and, event-driven, its return-time hints `_thint` ((M,))."""
    dev = torch.device(device)
    out = {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev)
           for k, v in po_par.items() if k != "_inner"}
    out["_inner"] = {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev)
                     for k, v in po_par["_inner"].items()}
    return out


def po_branch_to_numpy(br) -> Dict[str, Any]:
    """The comparable columns of a periodic-orbit branch of either package
    (a `Branch` or its `ContResult`): per-step `param`, `period`,
    `n_unstable`, and the Floquet exponents of each saved eigensolve
    (`floquet`, one row per step, in the solver's order: decreasing real
    part), and the special points' `type` and `param`.  `period` is the
    discretization's: the last unknown for the trapezoid, collocation and
    standard shooting, the sum of the return times for Poincare shooting
    (event-driven: the crossing times at the step)."""
    gamma = getattr(br, "gamma", br)
    tbl = gamma._table()
    return {
        "param": np.asarray(tbl["param"], dtype=float),
        "period": np.asarray(tbl["period"], dtype=float),
        "n_unstable": np.asarray(tbl["n_unstable"], dtype=int),
        "floquet": [np.asarray(e["eigenvals"]) for e in gamma.eig],
        "sp_type": np.asarray([sp.type for sp in gamma.specialpoint],
                              dtype=str),
        "sp_param": np.asarray([float(sp.param)
                                for sp in gamma.specialpoint], dtype=float),
    }


def _scalar_or_array(v):
    if isinstance(v, dict):
        return {k: _scalar_or_array(x) for k, x in v.items()}
    if callable(v) or isinstance(v, (bool, str)) or v is None:
        return v
    arr = _to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
    return arr.item() if arr.ndim == 0 else arr


def codim2_point_to_numpy(pt) -> Dict[str, Any]:
    """A codim-2 normal-form point of either package (`BogdanovTakens`,
    `Cusp`, `Bautin`, `ZeroHopf`, `HopfHopf`) as numpy: its type name
    `kind`, the `nf` dict (Python numbers, complex where complex; K10,
    K11, K2 and other vectors as arrays), `zeta` and `zeta_star` (pairs
    stacked as columns), `p`, and `omega` or `omega1`/`omega2` where the
    point has them."""
    out = {"kind": type(pt).__name__,
           "nf": {k: _scalar_or_array(v) for k, v in pt.nf.items()},
           "zeta": None if pt.zeta is None else _to_numpy(pt.zeta),
           "zeta_star": (None if pt.zeta_star is None
                         else _to_numpy(pt.zeta_star)),
           "p": None if pt.p is None else np.asarray(pt.p, dtype=float)}
    for k in ("omega", "omega1", "omega2"):
        if hasattr(pt, k):
            out[k] = float(getattr(pt, k))
    return out


def unfolding_to_numpy(nf: Dict[str, Any]) -> Dict[str, Any]:
    """An unfolding dict of either package (`bt_unfolding`,
    `bautin_unfolding`, `zh_unfolding`, `hh_unfolding`) as numpy: tensors
    and arrays as numpy arrays, 0-d ones as Python numbers, the nested
    `ns1`/`ns2` dicts likewise."""
    return {k: _scalar_or_array(v) for k, v in nf.items()}


def _tensor_of(v, device, dtype):
    arr = np.asarray(v)
    if np.iscomplexobj(arr):
        return torch.tensor(arr, dtype=torch.complex128, device=device)
    return torch.tensor(arr, dtype=dtype, device=device)


def po_ma_point_from_numpy(Y, params: Dict[str, Any], device,
                           dtype: torch.dtype = DEFAULT_DTYPE):
    """A point of a periodic-orbit minimally augmented curve handed over as
    numpy, as the port's (Y, params): Y = (X, p1[, theta]); the borders
    `_a` and `_b` (complex for Neimark-Sacker: complex128 tensors), the
    collocation data `_mesh`, `_uref` and `_phi`, and the vector field's
    parameters under `_inner` as 0-d tensors."""
    dev = torch.device(device)
    par = {k: _tensor_of(v, dev, dtype) for k, v in params.items()
           if k != "_inner"}
    par["_inner"] = {k: _tensor_of(v, dev, dtype)
                     for k, v in params["_inner"].items()}
    return _tensor_of(Y, dev, dtype), par


def po_ma_point_to_numpy(Y, params: Dict[str, Any]):
    """The inverse of `po_ma_point_from_numpy`, for either package's point:
    (Y as a numpy array, params with numpy arrays and Python floats under
    `_inner`)."""
    par = {k: _to_numpy(v) for k, v in params.items() if k != "_inner"}
    par["_inner"] = {k: float(_to_numpy(v))
                     for k, v in params["_inner"].items()}
    return _to_numpy(Y), par


def wave_state_to_numpy(X, n_inner: int) -> Tuple[np.ndarray, np.ndarray]:
    """A travelling-wave state [u_flat, s_1..s_k] of either package as
    (u_flat, speeds)."""
    X = _to_numpy(X)
    return X[:n_inner], X[n_inner:]


def bvp_nodes_to_numpy(X, n: int) -> np.ndarray:
    """A BVP state of either package as its (nodes, n) table: the
    discretization's node states one after the other (collocation,
    trapezoid or shooting)."""
    return _to_numpy(X).reshape(-1, n)
