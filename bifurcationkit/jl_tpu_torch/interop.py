"""Carry problem data and results between the JAX package and the port as
numpy arrays, so both compute from the same `u0` / `params` and their
branches can be compared column by column.  Nothing here imports JAX: the
JAX side hands over numpy arrays and plain Python numbers."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import DEFAULT_DTYPE


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
