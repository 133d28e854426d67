"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics read.

The traced window is a run of whole jobs, each inside a ``gnss_bench/job``
range.  From the profiler's raw events this keeps the device spans (every
kernel, copy and fill the card ran, with their names) and the host ranges
(``softgnss/<stage>``, from the program's ``StageTimer``, and the jobs).
Times are microseconds on the profiler's one clock.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

JOB_RANGE = "gnss_bench/job"
STAGE_PREFIX = "softgnss/"


@dataclass
class Trace:
    #: (start, end, name, is_kernel) of every device operation
    device: list = field(default_factory=list)
    #: host range name -> [(start, end)]
    ranges: dict = field(default_factory=lambda: defaultdict(list))

    @property
    def window(self) -> tuple[float, float]:
        jobs = self.ranges[JOB_RANGE]
        return min(a for a, _ in jobs), max(b for _, b in jobs)


def _raw_events(prof):
    """(name, on_device, activity, start_us, end_us) of every event, read
    from the profiler's raw results (building its FunctionEvents would take
    longer than the traced jobs).  ``activity`` is "" where torch does not
    give it (2.11 does not)."""
    for e in prof.profiler.kineto_results.events():
        activity = e.activity_type() if hasattr(e, "activity_type") else ""
        yield (e.name(), str(e.device_type()).endswith("CUDA"), str(activity),
               e.start_ns() / 1e3, e.end_ns() / 1e3)


def collect(prof) -> Trace:
    out = Trace()
    for name, on_device, activity, a, b in _raw_events(prof):
        if on_device:
            if "annotation" in activity or name.startswith((STAGE_PREFIX, "gnss_bench/")):
                continue
            kernel = activity == "kernel" if activity else not name.startswith(("Memcpy", "Memset"))
            out.device.append((a, b, name, kernel))
        elif name.startswith((STAGE_PREFIX, "gnss_bench/")):
            out.ranges[name].append((a, b))
    return out


def merged(spans) -> list[tuple[float, float]]:
    """Sorted disjoint union of (start, end) spans."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(spans, ranges) -> float:
    """Length of the union of ``spans`` that lies inside the union of ``ranges``."""
    rs = merged(ranges)
    total, i = 0.0, 0
    for a, b in merged(spans):
        while i < len(rs) and rs[i][1] <= a:
            i += 1
        j = i
        while j < len(rs) and rs[j][0] < b:
            total += max(0.0, min(b, rs[j][1]) - max(a, rs[j][0]))
            j += 1
    return total


def length(ranges) -> float:
    return sum(b - a for a, b in merged(ranges))


def busy_us(tr: Trace, ranges=None, kernels_only: bool = False) -> float:
    """Device-busy microseconds inside ``ranges`` (the window by default)."""
    spans = [(a, b) for a, b, _, k in tr.device if k or not kernels_only]
    return covered(spans, [tr.window] if ranges is None else ranges)


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", name)[:64]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps inside
    the window by the host range they fall in (seconds)."""
    lo, hi = tr.window
    ops: dict = defaultdict(float)
    for a, b, name, _ in tr.device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ops[_label(name)] += (b - a) / 1e6
    stages = sorted((a, b, name) for name, rs in tr.ranges.items() if name != JOB_RANGE
                    for a, b in rs)
    gaps: dict = defaultdict(lambda: [0, 0.0, 0.0])
    prev = lo
    for a, b in merged([(max(a, lo), min(b, hi)) for a, b, _, _ in tr.device
                        if b > lo and a < hi]) + [(hi, hi)]:
        if a > prev:
            where = next((n for s, e, n in stages if s <= prev < e), "between_stages")
            g = gaps[where]
            g[0] += 1
            g[1] += (a - prev) / 1e6
            g[2] = max(g[2], (a - prev) / 1e3)
        prev = max(prev, b)
    idle = [[_label(f"{n}: {g[0]} gaps, longest {g[2]:.3f} ms"), g[1]]
            for n, g in sorted(gaps.items(), key=lambda kv: -kv[1][1])]
    return {"device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": idle[:top]}
