"""Checkpoint / save / resume — the port of `jl_tpu/utils/io.py` (ref
ext/JLD2Ext/save.jl + the iterator API as the checkpointing surface).

Branches serialize to one `.npz` (numpy archive) in the JAX package's
layout: the branch table (`branch/<column>`), eigen-elements
(`eig/<i>/vals|vecs|step`), saved solutions (`sol/<i>/x|p|step`) and
special points (`specialpoints_json`, `sp/<i>/x`).  A file saved by either
package loads in the other.  `save_every_step` returns a finalise hook
that checkpoints every few steps, mirroring the reference's
`save_to_file` option (ref src/ContParameters.jl:64); `resume_data`
gives the last saved state to resume from.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import resolve_device
from ..continuation.results import ContResult
from ..detection.points import SpecialPoint


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_branch(br, path: str):
    """Serialize a ContResult/Branch to `<path>.npz`; returns the path."""
    gamma = getattr(br, "gamma", br)
    payload = {f"branch/{k}": _host(v) for k, v in gamma._table().items()}
    for i, e in enumerate(gamma.eig):
        payload[f"eig/{i}/vals"] = _host(e["eigenvals"])
        if e.get("eigenvecs") is not None:
            payload[f"eig/{i}/vecs"] = _host(e["eigenvecs"])
        payload[f"eig/{i}/step"] = np.asarray(e["step"])
    for i, s in enumerate(gamma.sol):
        payload[f"sol/{i}/x"] = _host(s["x"])
        payload[f"sol/{i}/p"] = _host(s["p"])
        payload[f"sol/{i}/step"] = np.asarray(s["step"])
    sps = []
    for sp in gamma.specialpoint:
        sps.append({"type": sp.type, "idx": int(sp.idx),
                    "param": float(sp.param), "step": int(sp.step),
                    "status": sp.status,
                    "interval": [float(sp.interval[0]),
                                 float(sp.interval[1])],
                    "delta": [int(sp.delta[0]), int(sp.delta[1])]})
        if sp.x is not None:
            payload[f"sp/{len(sps) - 1}/x"] = _host(sp.x)
    payload["specialpoints_json"] = np.frombuffer(
        json.dumps(sps).encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, **payload)
    return path


def load_branch(path: str, device=None) -> ContResult:
    """Reload a branch saved by `save_branch` (of either package).  The
    saved solutions and special-point states come back as tensors on
    `device` (None means the card; pass `device="cpu"` on the CPU); the
    branch table and the eigen-elements stay on the host, as the engine
    records them."""
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    res = ContResult()
    cols = {k.split("/", 1)[1]: z[k] for k in z.files
            if k.startswith("branch/")}
    nrows = len(next(iter(cols.values()))) if cols else 0
    for i in range(nrows):
        res._records.append({k: v[i] for k, v in cols.items()})
    eig_idx = sorted({int(k.split("/")[1]) for k in z.files
                      if k.startswith("eig/")})
    for i in eig_idx:
        res.eig.append({
            "eigenvals": z[f"eig/{i}/vals"],
            "eigenvecs": z.get(f"eig/{i}/vecs"),
            "step": int(z[f"eig/{i}/step"]),
            "converged": True})
    sol_idx = sorted({int(k.split("/")[1]) for k in z.files
                      if k.startswith("sol/")})
    for i in sol_idx:
        res.sol.append({"x": torch.as_tensor(z[f"sol/{i}/x"], device=dev),
                        "p": float(z[f"sol/{i}/p"]),
                        "step": int(z[f"sol/{i}/step"])})
    sps = json.loads(bytes(z["specialpoints_json"]).decode())
    for i, d in enumerate(sps):
        sp = SpecialPoint(type=d["type"], idx=d["idx"], param=d["param"],
                          step=d["step"], status=d["status"],
                          interval=tuple(d["interval"]),
                          delta=tuple(d["delta"]))
        key = f"sp/{i}/x"
        if key in z.files:
            sp.x = torch.as_tensor(z[key], device=dev)
        res.specialpoint.append(sp)
    return res


def save_every_step(path: str, every: int = 10):
    """finalise_solution hook: checkpoint the running branch every `every`
    steps (ref save_to_file appending, ext/JLD2Ext/save.jl:8-48)."""

    def hook(z, tau, step, res, state=None, **kwargs):
        if step % every == 0:
            save_branch(res, path)
        return True

    return hook


def resume_data(path: str, device=None):
    """(x_last, p_last, branch) of a checkpoint, for resuming a run; x on
    `device` as in `load_branch`."""
    res = load_branch(path, device=device)
    if not res.sol:
        raise ValueError("checkpoint has no saved solutions")
    last = res.sol[-1]
    return last["x"], last["p"], res
