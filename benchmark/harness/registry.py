"""Finds a cell's parts by the names that BENCHMARK.json gives them.

A configuration is `configs/<name>.json` (its sizes and solver settings),
`configs/<name>.py` (the builder of the system under test) and
`reference/<name>.py` (its plain reference and the comparison that decides
`correct`).  A traffic mix is `traffic/<name>.json`, data alone.  A metric
is `metrics/<name>.py`, a reader with a `read(ctx)` function.  Nothing here
names a cell: a new cell, configuration, mix or metric is new files and new
entries in BENCHMARK.json.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = BENCH_DIR.parent


def load_spec(path: Path = None) -> dict:
    """The parsed BENCHMARK.json at the root of the checkout."""
    path = REPO_ROOT / "BENCHMARK.json" if path is None else Path(path)
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        "_bench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path, name: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the spec with everything found by name."""

    def __init__(self, spec: dict, workload: str, root: Path = BENCH_DIR):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.root = Path(root)
        self.spec = spec

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def config(self) -> dict:
        """The configuration's file, as BENCHMARK.json's `file` names it."""
        name = self.config_entry["name"]
        return _json(self.root.parent / self.config_entry["file"], name)

    def builder(self):
        name = self.config_entry["name"]
        return _module(self.root / "configs" / f"{name}.py", name)

    def reference(self):
        name = self.config_entry["name"]
        return _module(self.root / "reference" / f"{name}.py",
                       "ref_" + name)

    def traffic(self) -> dict:
        name = self.workload["traffic"]
        return _json(self.root / "traffic" / f"{name}.json", name)

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end ones with
        `trace` 0, its per-layer ones with `trace` 1."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        name = self.workload["name"]
        return [m for m in group
                if "workloads" not in m or name in m["workloads"]]

    def reader(self, metric: str):
        return _module(self.root / "metrics" / f"{metric}.py",
                       "metric_" + metric)
