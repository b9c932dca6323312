"""The comparison that decides `correct` fails what it must: its control
(the reference in the next precision down put in the program's place),
and a run whose timed path is broken underneath, once for each fault a
cell can have.  On the CPU at tiny sizes; the harness's look for a card is
skipped, the rest of a run is driven as `run.py` drives it."""
import pytest
import torch

import _tiny
from harness import registry, runner
from bifurcationkit.jl_tpu_torch.continuation import engine

SPEC = registry.load_spec()
SEED = 2 ** 31 + 77
CELLS = {"sh512.detect": _tiny.SH_TINY, "bruss_po.floquet": None}


def _over(cell):
    return CELLS[cell] or _tiny.bruss_tiny(8)


def _run(cell, **kw):
    reg = registry.Cell(SPEC, cell)
    return runner.measure(reg, SEED, 20.0, False, device="cpu",
                          config_over=_over(cell), max_points=10, **kw)


def _failed(numbers):
    return [c["name"] for c in numbers if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    result, extra = _run(cell, with_control=True)
    assert result["correct"], extra["numbers"]
    assert _failed(extra["control"]), extra["control"]


def _patch_iterate(monkeypatch, after):
    """Breaks the engine's step: `after(state, z_before)` runs after each
    converged step."""
    orig = engine.ContIterable.iterate

    def iterate(self, state):
        before = state.z
        out = orig(self, state)
        if state.converged:
            after(state, before)
        return out

    monkeypatch.setattr(engine.ContIterable, "iterate", iterate)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    def unchanged(state, before):
        state.z = before

    _patch_iterate(monkeypatch, unchanged)
    result, extra = _run(cell)
    assert not result["correct"]
    assert "arclength" in _failed(extra["numbers"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    def altered(state, before):
        u = state.z.u
        state.z = type(state.z)(u=u + 1e-6 * torch.ones_like(u), p=state.z.p)

    _patch_iterate(monkeypatch, altered)
    result, extra = _run(cell)
    assert not result["correct"]
    assert "residual" in _failed(extra["numbers"])


def test_half_the_batch_left_out():
    """sh512.detect: the J.v of a block of K vectors computes the first
    half and leaves the rest out."""
    def fault(cell):
        inner = cell.prob.jac_op

        def jac_op(u, par):
            op = inner(u, par)

            def half(v):
                out = op(v)
                if v.dim() == 3:
                    out = out.clone()
                    out[v.shape[0] // 2:] = 0
                return out

            return half

        object.__setattr__(cell.prob, "jac_op", jac_op)

    result, extra = _run("sh512.detect", fault=fault)
    assert not result["correct"]
    assert "jv_f32" in _failed(extra["numbers"])


def test_eigenvalues_altered_where_they_are_produced(monkeypatch):
    """sh512.detect: the eigensolver hands back its Ritz values shifted by
    the preconditioner's shift, which it should have taken back out; the
    stability counts no longer match the reference's."""
    from bifurcationkit.jl_tpu_torch.linalg.eig import LOBPCGEig

    orig = LOBPCGEig.__call__

    def shifted(self, *a, **kw):
        vals, vecs, cv, it = orig(self, *a, **kw)
        return vals + 1.0, vecs, cv, it

    monkeypatch.setattr(LOBPCGEig, "__call__", shifted)
    result, extra = _run("sh512.detect")
    assert not result["correct"]
    assert "counts" in _failed(extra["numbers"])


def test_half_the_gauss_points_left_out():
    """bruss_po.floquet: the vector field over the collocation's batch of
    Gauss points evaluates the first half and leaves the rest out."""
    def fault(cell):
        inner = cell.prob.F

        def F(x, par):
            out = inner(x, par)
            if x.dim() == 2 and x.shape[0] > 1:
                out = out.clone()
                out[x.shape[0] // 2:] = 0
            return out

        object.__setattr__(cell.prob, "F", F)

    result, extra = _run("bruss_po.floquet", fault=fault)
    assert not result["correct"]
