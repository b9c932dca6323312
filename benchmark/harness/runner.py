"""One run of one cell: set-up, the measured window, the metrics, then the
comparison with the plain reference that decides `correct`.

`measure` does everything but look for a card, so the CPU tests drive it
at tiny sizes; `run.py` looks for the card and prints what it returns.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import peaks, profiling
from .window import Window


def _program_counters(builder_counts):
    """The counters a traced slice reads at its start and end: the vectors
    through the model's jac_op by (dtype, K), and the kernel's own launch
    counter as a cross-check of the profiler's drop rate."""
    from bifurcationkit.jl_tpu_torch.ops import sh_jv

    def read():
        return dict(builder_counts, sh_jv_launches=sh_jv.launch_count())
    return read


def _jv_inputs(cell, pts, seed, k):
    """The program's J.v at `k` points drawn from the seed: float64 at
    K = 1 (the Krylov solves' products) and float32 at K = 15 (the
    eigensolver's block), on vectors made from the seed."""
    from reference import common

    idx = common.sample(len(pts), k, seed + 1)
    gen = torch.Generator(device=pts[0]["u"].device).manual_seed(seed + 2)
    out = []
    for i in idx:
        u = pts[i]["u"]
        for dtype, K in ((torch.float64, 1), (torch.float32, 15)):
            shape = tuple(u.shape) if K == 1 else (K,) + tuple(u.shape)
            v = torch.randn(shape, generator=gen, dtype=torch.float64,
                            device=u.device).to(dtype)
            got = cell.program_jv(u.to(dtype).contiguous(), pts[i]["p"], v)
            out.append((i, v, got))
    return out


def measure(reg, seed: int, seconds: float, trace: bool, device="cuda",
            t_process: float = None, config_over: dict = None,
            fault=None, with_control: bool = False, max_points: int = None):
    """Runs the cell `reg` (a `registry.Cell`) and returns the result's
    fields.  `config_over` changes configuration keys (the CPU tests' tiny
    sizes), `fault` is called with the built cell before the window (the
    tests' broken timed paths), `with_control` also judges the control:
    the reference in the next precision down put in the program's place."""
    t_process = time.perf_counter() if t_process is None else t_process
    cfg = reg.config()
    cfg.update(config_over or {})
    mix = reg.traffic()
    builder, reference = reg.builder(), reg.reference()
    dev = torch.device(device)
    t_build = time.perf_counter()
    cell = builder.build(cfg, mix, seed, dev)
    if fault is not None:
        fault(cell)
    sl = None
    if trace:
        counts = cell.instrument()
        sl = profiling.TraceSlice(mix["trace"]["start_point"],
                                  mix["trace"]["points"], device=dev,
                                  read_counters=_program_counters(counts))
    win = Window(cell, seconds, dev, trace=sl, max_points=max_points).run()
    setup_s = win.t_start - t_process
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    for i, q in enumerate(win.points):
        q["profiled"] = sl is not None and (sl.covers(i)
                                            or sl.covers(i - 1))
    ctx = dict(points=win.points, window_s=win.window_s, setup_s=setup_s,
               config=cfg, peaks=peaks.H100, trace=None)
    notes = {"jobs": len(win.jobs), "points": len(win.points),
             "setup_parts": dict(before_build_s=t_build - t_process,
                                 **getattr(cell, "setup_parts", {}))}
    if sl is not None and sl.closed:
        t = time.perf_counter()
        summ = profiling.summarize(sl.events(), sl.t1 - sl.t0)
        summ["points"] = sl.points
        summ["counters"] = sl.counters()
        ctx["trace"] = summ
        kept = sum(c for n, (_, c) in summ["rows"].items()
                   if "sh_jv_kernel" in n)
        launched = summ["counters"].get("sh_jv_launches", 0)
        notes.update(trace_read_s=time.perf_counter() - t,
                     trace_points=sl.points,
                     sh_jv_launched=launched, sh_jv_events_kept=kept)
        sl.prof = None

    metrics = {}
    for m in reg.metrics(trace):
        value = reg.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's outputs that the reference judges, then the program's
    # state freed before the reference runs
    outputs = {"points": win.points, "theta": cell.theta(), "jv": []}
    chk = mix.get("check", {})
    if win.points and hasattr(cell, "program_jv"):
        outputs["jv"] = _jv_inputs(cell, win.points, seed,
                                   chk.get("jv_points", 0))
    errors = [e for _, _, e in win.jobs if e]
    win.cell = cell = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = reference.check(cfg, mix, outputs, seed) \
        if win.points else []
    notes["reference_s"] = time.perf_counter() - t
    if with_control and win.points:
        extra_control = reference.check(cfg, mix, outputs, seed,
                                        control=True)
    else:
        extra_control = None
    correct = bool(win.points) and not errors and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in numbers)
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics}
    extra = {"ctx": ctx, "notes": notes, "numbers": numbers,
             "errors": errors, "peak": peak, "control": extra_control}
    if ctx["trace"] is not None:
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                               "idle_gaps": ctx["trace"]["idle_gaps"]}
    return result, extra


def checks_field(numbers) -> dict:
    """The compared numbers, each beside its limit, for the result line."""
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in numbers}


def print_checks(numbers, stream=sys.stderr):
    for c in numbers:
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{verdict}", file=stream)
    stream.flush()
