"""Plotting recipes — the port of `jl_tpu/utils/plotting.py` (ref
src/plotting/Utils.jl + ext/PlotsExt, MakieExt).

Backend = matplotlib, imported lazily: without it every recipe does
nothing and warns.  The recipes mirror the reference's: branch plots
styled by stability with special-point markers, periodic-orbit plots, and
bifurcation-diagram trees.  Branch tables live on the host, so nothing
here touches the card.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

_MARKERS = {"bp": ("s", "tab:blue"), "fold": ("o", "tab:red"),
            "hopf": ("D", "tab:purple"), "nd": ("*", "tab:brown"),
            "pd": ("v", "tab:orange"), "ns": ("^", "tab:green"),
            "bt": ("P", "black"), "cusp": ("X", "black"),
            "gh": ("h", "tab:pink"), "zh": ("H", "tab:olive"),
            "hh": ("8", "tab:cyan")}


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except Exception as e:  # matplotlib missing or broken
        warnings.warn(f"matplotlib unavailable: {e}")
        return None


def plot_branch(br, x: str = "param", y: str = "norm", ax=None,
                show_stability: bool = True, show_special: bool = True,
                label: Optional[str] = None, **kwargs):
    """Plot a branch `y(x)` with stability styling + special-point markers
    (ref plot recipes, ext/PlotsExt)."""
    plt = _plt()
    if plt is None:
        return None
    gamma = getattr(br, "gamma", br)
    if ax is None:
        _, ax = plt.subplots()
    xs = np.asarray(gamma[x], dtype=float)
    ys = np.asarray(gamma[y], dtype=float)
    if show_stability and "stable" in gamma._table():
        stable = np.asarray(gamma["stable"], dtype=bool)
        # draw contiguous stable/unstable segments
        start = 0
        for i in range(1, len(xs) + 1):
            if i == len(xs) or stable[i] != stable[start]:
                end = i + 1 if i < len(xs) else i
                ax.plot(xs[start:end], ys[start:end],
                        "-" if stable[start] else "--",
                        color=kwargs.get("color", "tab:blue"),
                        label=label if start == 0 else None)
                start = i
    else:
        ax.plot(xs, ys, "-", label=label, **kwargs)
    if show_special:
        for sp in gamma.specialpoint:
            if sp.type == "endpoint":
                continue
            marker, color = _MARKERS.get(sp.type, ("x", "gray"))
            yv = ys[min(sp.idx, len(ys) - 1)]
            ax.plot([sp.param], [yv], marker, color=color, ms=8, zorder=5)
            ax.annotate(sp.type, (sp.param, yv), fontsize=8,
                        textcoords="offset points", xytext=(4, 4))
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    return ax


def plot_periodic_orbit(br_po, idx: int = -1, ax=None, **kwargs):
    """Plot the components of a saved periodic orbit over one period."""
    plt = _plt()
    if plt is None:
        return None
    from ..periodic.orbits import orbit_from_branch

    traj, T, p = orbit_from_branch(br_po, idx)
    if ax is None:
        _, ax = plt.subplots()
    ts = np.linspace(0, T, traj.shape[0])
    for i in range(traj.shape[1]):
        ax.plot(ts, traj[:, i], label=f"u{i + 1}", **kwargs)
    ax.set_xlabel("t")
    ax.set_title(f"periodic orbit at p = {p:.5g} (T = {T:.5g})")
    ax.legend()
    return ax


def plot_bifurcation_diagram(node, x: str = "param", y: str = "norm",
                             ax=None, **kwargs):
    """Plot a whole BifDiagNode tree (ref plot recipe for
    bifurcationdiagram)."""
    plt = _plt()
    if plt is None:
        return None
    if ax is None:
        _, ax = plt.subplots()
    plot_branch(node.gamma, x=x, y=y, ax=ax, **kwargs)
    for child in node.children:
        plot_bifurcation_diagram(child, x=x, y=y, ax=ax, **kwargs)
    return ax


def savefig(ax, path: str):
    plt = _plt()
    if plt is None or ax is None:
        return
    ax.figure.savefig(path, dpi=130, bbox_inches="tight")
