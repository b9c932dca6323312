"""The traced slice of a `--trace 1` run: torch.profiler over a fixed number
of branch points, the card's activity alone, read after the window closes.

Copied, with changes, from `chip_smoke.py`: `_kernel_rows` and
`_profile(cuda_only=True)` (the card's activity alone: with the host's op
events the profiler's post-processing of a 200,000-launch step took about
90 s) and the mean-of-kept-events rule of `_device_time` (the H100's
profiler drops a few kernel events of a profile, so a kernel's time is the
mean over the events it kept times the launches counted elsewhere).  Unlike
`chip_smoke.py::_busy_fields`, the idle share divides the busy time by the
traced slice's own wall time.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

# activity records that are copies or fills, not kernel launches
_NOT_KERNELS = ("Memcpy", "Memset")


def is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


class TraceSlice:
    """Profiles the points with index in [start, start + count) of a
    window; `on_point(i)` is called after point i's stamp (the card
    synchronised).  `read_counters()` is read as the slice opens and
    closes."""

    def __init__(self, start: int, count: int, device="cuda",
                 read_counters=dict):
        self.start, self.count = start, count
        self.cuda = torch.device(device).type == "cuda"
        self.read_counters = read_counters
        self.prof = None
        self.t0 = self.t1 = None
        self.closed = False
        self.counters_at_open = None
        self.counters_at_close = None

    def covers(self, i: int) -> bool:
        return self.start < i + 1 <= self.start + self.count

    def on_point(self, i: int):
        if self.closed:
            return
        if self.prof is None and i + 1 == self.start:
            from torch.profiler import ProfilerActivity, profile

            # the card's activity alone (the CPU's for the CPU tests)
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
            self.counters_at_open = self.read_counters()
            self.prof.__enter__()
            self._sync()
            self.t0 = time.perf_counter()
        elif self.prof is not None and i + 1 == self.start + self.count:
            self.close()

    def close(self):
        """Ends the slice (also where the window ends inside it)."""
        if self.prof is None or self.closed:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.counters_at_close = self.read_counters()
        self.prof.__exit__(None, None, None)
        self.closed = True

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @property
    def points(self) -> int:
        """Points inside the slice (fewer than `count` where the window
        closed first)."""
        return self.count if self.closed else 0

    def counters(self) -> dict:
        """Counter increments over the slice."""
        a, b = self.counters_at_open or {}, self.counters_at_close or {}
        return {k: b[k] - a.get(k, 0) for k in b}

    def events(self):
        """(name, start_us, end_us) of every activity record the profiler
        kept, in start order."""
        from torch.autograd import DeviceType

        want = DeviceType.CUDA if self.cuda else DeviceType.CPU
        out = []
        for e in self.prof.events():
            if e.device_type != want:
                continue
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
        out.sort(key=lambda r: r[1])
        return out


def summarize(events, wall_s: float) -> dict:
    """What the metric readers take from a slice's records: the busy
    seconds (the union of the records' intervals), the kernel rows by name
    (device seconds, events kept), the kernel count, the top operations
    and the longest idle gaps, each gap named by the kernels around it."""
    rows = defaultdict(lambda: [0.0, 0])
    busy_us, cur_s, cur_e = 0.0, None, None
    gaps = defaultdict(float)
    prev_name = None
    for name, s, e in events:
        r = rows[name]
        r[0] += (e - s) * 1e-6
        r[1] += 1
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps[f"{_short(prev_name)} -> {_short(name)}"] += (s - cur_e) \
                * 1e-6
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_name = name
    if cur_e is not None:
        busy_us += cur_e - cur_s
    kernels = {n: r for n, r in rows.items() if is_kernel(n)}
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": wall_s,
        "rows": {n: (r[0], r[1]) for n, r in rows.items()},
        "launches": sum(r[1] for r in kernels.values()),
        "device_ops": [[_short(n), r[0]] for n, r in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _short(name) -> str:
    """A kernel's name without its argument list, at most 90 characters."""
    if name is None:
        return "window start"
    name = name.split("(")[0] if not name.startswith("void ") \
        else name[5:].split("(")[0]
    return name.strip()[:90] or "(unnamed)"

