"""The metric readers' arithmetic on synthetic points, profiler rows and
counters; the trace summary; the import guard; BENCHMARK.json against the
benchmark's contract."""
import json
import re

import numpy as np
import pytest

from harness import guard, peaks, profiling, registry

SPEC = registry.load_spec()
CELL = registry.Cell(SPEC, "sh512.detect")


def read(name, ctx):
    return CELL.reader(name).read(ctx)


def _points(dts, special=(), itn=2, itl=300, profiled=()):
    return [dict(dt=dt, itnewton=itn, itlinear=itl,
                 special=[{"type": "bp"}] if i in special else [],
                 profiled=i in profiled) for i, dt in enumerate(dts)]


def _ctx(points, window_s=10.0, trace=None, setup_s=12.5):
    return dict(points=points, window_s=window_s, setup_s=setup_s,
                trace=trace, config={"Nx": 512, "Ny": 512},
                peaks=peaks.H100)


def test_window_metrics():
    dts = [0.5] * 18 + [1.0, 2.0]
    ctx = _ctx(_points(dts, special={19}), window_s=sum(dts) + 0.5)
    assert read("points_per_s", ctx) == pytest.approx(20 / 12.5)
    assert read("point_p90_s", ctx) == pytest.approx(
        np.percentile(dts, 90))
    assert read("setup_s", ctx) == 12.5
    assert read("newton_iters_per_point", ctx) == 2
    assert read("linear_iters_per_point", ctx) == 300
    assert read("bisect_share", ctx) == pytest.approx(100 * 2.0 / 12.5)
    assert read("bisect_share", _ctx(_points([0.5] * 4))) == 0.0
    assert read("points_per_s", _ctx([])) is None


def test_p90_leaves_out_the_profiled_slice():
    dts = [0.5] * 10 + [9.0, 9.0]
    ctx = _ctx(_points(dts, profiled={10, 11}))
    assert read("point_p90_s.sh512", ctx) == pytest.approx(0.5)


def _trace(rows, busy=0.2, wall=1.0, launches=1000, points=4, counters=None):
    return dict(rows=rows, busy_s=busy, window_s=wall, launches=launches,
                points=points, counters=counters or {})


def test_device_metrics():
    rows = {"void vector_fft<...>": (0.02, 100),
            "void regular_fft_factor<...>": (0.01, 10),
            "getrf_kernel": (0.05, 3), "trsm_left_kernel": (0.03, 9),
            "elementwise_kernel": (0.09, 878)}
    tr = _trace(rows)
    ctx = _ctx(_points([0.5] * 4), trace=tr)
    assert read("idle_share", ctx) == pytest.approx(80.0)
    assert read("launches_per_point", ctx) == 250
    assert read("fft_busy_share", ctx) == pytest.approx(15.0)
    assert read("lu_busy_share", ctx) == pytest.approx(40.0)
    assert read("idle_share", _ctx([], trace=None)) is None
    assert read("fft_busy_share", _ctx([], trace=_trace({"x": (1, 1)}))) \
        is None


def test_sh_jv_roofline_counts_bytes_and_mean_of_kept_events():
    # 100 f32 calls at K = 1 and 10 f64 calls at K = 15 counted at the
    # jac_op boundary; the profiler kept 90 and 10 of their events
    counters = {("float32", 1): 100, ("float64", 15): 10,
                "sh_jv_launches": 110}
    rows = {"void sh_jv_kernel<float, 1, 1>(...)": (90 * 4e-6, 90),
            "void sh_jv_kernel<double, 1, 1>(...)": (10 * 20e-6, 10)}
    ctx = _ctx([], trace=_trace(rows, counters=counters))
    n = 512 * 512
    nbytes = 100 * 3 * n * 4 + 10 * 31 * n * 8
    seconds = 100 * 4e-6 + 10 * 20e-6
    want = 100 * nbytes / 3.35e12 / seconds
    assert read("sh_jv_roofline", ctx) == pytest.approx(want)
    assert 0 < want < 100


def test_summarize_busy_union_and_gaps():
    ev = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("Memcpy DtoH", 20.0, 25.0),
          ("void k3<float>(int)", 40.0, 45.0)]
    s = profiling.summarize(ev, wall_s=50e-6)
    assert s["busy_s"] == pytest.approx(22e-6)
    assert s["launches"] == 3
    assert s["rows"]["k2"] == (pytest.approx(7e-6), 1)
    gaps = dict(s["idle_gaps"])
    assert gaps["Memcpy DtoH -> k3<float>"] == pytest.approx(15e-6)
    assert gaps["k2 -> Memcpy DtoH"] == pytest.approx(8e-6)
    assert len(s["device_ops"]) <= 10


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("bifurcationkit.jl_tpu", True),
    ("bifurcationkit.jl_tpu.core.state", True),
    ("bifurcationkit.jl_tpu_torch", False),
    ("bifurcationkit.jl_tpu_torch.ops.sh_jv", False),
    ("bifurcationkit", False), ("jaxtyping", False), ("jl_tpu", False)])
def test_import_guard_compares_whole_names(name, bad):
    assert guard.forbidden(name) is bad


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports_program(registry.BENCH_DIR
                                           / "reference") == []


def test_guard_finds_a_reference_that_imports_the_port(tmp_path):
    (tmp_path / "r.py").write_text(
        "import torch\nfrom bifurcationkit.jl_tpu_torch import models\n")
    assert guard.reference_imports_program(tmp_path) == [
        "r.py: bifurcationkit.jl_tpu_torch"]


# ---------------------------------------------------------------------------
# BENCHMARK.json against the contract's limits
# ---------------------------------------------------------------------------
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_spec_keys_names_and_limits():
    spec = SPEC
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    assert 1 <= len(spec["paths"]) <= 16
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        data = json.loads((registry.REPO_ROOT / c["file"]).read_text())
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    names = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(w in names for w in m.get("workloads", names))
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    all_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(all_names) == len(set(all_names))
    for w in names:
        reg = registry.Cell(spec, w)
        e = [m["name"] for m in reg.metrics(False)]
        assert "setup_s" in e and len(e) >= 2
        assert reg.metrics(True)
    # a full check fits its time with the full 24 cells
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(CELL.reader(m["name"]).read)

