"""`run.py` as the driver runs it: a three-point run of each cell on the
card (marked `cuda`; it skips where there is no card; a job's first point
has no arclength row, its next two have), and the refusals: no
result without a card, none in a directory that holds only the benchmark,
and an added cell that runs from new files alone."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

import _tiny
from harness import registry, runner

ROOT = registry.REPO_ROOT


def _run_py(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sh512.detect", "bruss_po.floquet"])
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    reg = registry.Cell(registry.load_spec(), cell)
    result, extra = runner.measure(reg, 2 ** 31 + 5, 60.0, False,
                                   device="cuda", max_points=3)
    assert result["correct"], extra["numbers"]
    assert result["attempted"] == 3 and result["failed"] == 0


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT, "--workload", "bruss_po.floquet", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_no_result_from_the_benchmark_alone(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    out = _run_py(tmp_path, "--workload", "bruss_po.floquet", "--seed", "1",
                  "--seconds", "2", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_added_from_new_files_runs(tmp_path):
    """A new traffic mix and a new metric, as files, and new entries: the
    harness finds them by name and runs the cell."""
    bench = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((bench / "traffic" / "floquet.json").read_text())
    mix["continuation"].update(dsmax=0.01, max_steps=6)
    (bench / "traffic" / "short_jobs.json").write_text(json.dumps(mix))
    (bench / "metrics" / "jobs_per_s.py").write_text(
        "def read(ctx):\n"
        "    jobs = {q['job'] for q in ctx['points']}\n"
        "    return len(jobs) / ctx['window_s'] if jobs else None\n")
    spec = registry.load_spec()
    spec["workloads"].append({
        "name": "bruss_po.short", "config": "brusselator_po_coll",
        "traffic": "short_jobs", "chips": 1, "why": "short jobs"})
    spec["end_to_end"].append({
        "name": "jobs_per_s", "unit": "jobs/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["bruss_po.short"]})
    reg = registry.Cell(spec, "bruss_po.short", root=bench)
    result, extra = runner.measure(reg, 3, 30.0, False, device="cpu",
                                   config_over=_tiny.bruss_tiny(8),
                                   max_points=9)
    assert result["correct"], extra["numbers"]
    assert result["metrics"]["jobs_per_s"]["value"] > 0
    assert {q["job"] for q in extra["ctx"]["points"]} == {0, 1}
