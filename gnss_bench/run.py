"""Run one cell of the benchmark once and print its result line.

    python3 -m gnss_bench.run --workload ref38.obs --seed 7 --seconds 40 --trace 0

Set-up: imports and CUDA start, the traffic mix's distinct captures
synthesized on the card from the seed (``generator``), one warm-up job on
each (the first builds the kernels on a checkout's first run), then
``gc.collect(); gc.freeze()`` so that the collector's passes over what
set-up made fall outside the window.  Then the window: jobs back to back
for ``--seconds`` (one client, a closed loop), job j on capture j mod K,
one clock read per job.  Of each capture two jobs are kept: its first,
and the first to start in its own K-th of the window at or after a time
drawn from the seed (so the last capture's lies in the window's last
part); every other job's outputs are dropped.  With ``--trace 1`` a few more whole jobs run under the profiler
after the window, and the per-layer metrics are read (``metrics/``).
After the window the judged jobs are held to the plain reference
(``judge``).  The last lines of standard error are the numbers compared,
each with its limit; the last line of standard output is the result.
Exits non-zero, printing no result, without the CUDA devices the cell
needs or when the process holds JAX or the JAX package once the window
has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from gnss_bench import registry  # noqa: E402

#: top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "softgnss_tpu")
#: whole jobs under the profiler in a traced run
TRACED_JOBS = 5


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    timings: list                  # each window job's ReceiverResults.timings_s
    channels: int                  # channels tracked per job
    n_ms: int
    samples_per_code: int
    trace: object = None           # trace.Trace of TRACED_JOBS whole jobs
    traced_jobs: int = 0


@dataclass
class CellRun:
    result: dict
    notes: list = field(default_factory=list)


def receiver_config(table: dict):
    """The program's ReceiverConfig for a configuration's receiver table."""
    from softgnss_tpu_torch.config import default_config

    return default_config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in table.items()})


def outputs_of(res) -> dict:
    """A job's outputs as plain arrays (what ``judge`` reads)."""
    import numpy as np

    acq, ch, tr = res.acquisition, res.channels, res.tracking
    out = {"acq_carr_freq": acq.carr_freq, "acq_code_phase": acq.code_phase,
           "acq_doppler_bin": acq.doppler_bin, "prn": np.asarray(ch.prn),
           "acquired_freq": np.asarray(ch.acquired_freq),
           "code_phase": np.asarray(ch.code_phase), "status": list(tr.status)}
    from gnss_bench.judge import TRACK_KEYS

    out.update({k: np.asarray(getattr(tr, k)) for k in TRACK_KEYS})
    return out


def judged_starts(seed: int, k: int) -> list[float]:
    """For each of k captures, the share of the window at or after which
    its drawn judged job starts: capture i's lies in [i / k, (i + 1) / k)."""
    import numpy as np

    u = np.random.default_rng([int(seed), 1]).uniform(size=k)
    return [float((i + u[i]) / k) for i in range(k)]


def run_cell(bench: dict, cell: dict, config_table: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda") -> CellRun:
    """Set-up, window, traced jobs and judging of one run of ``cell``."""
    import numpy as np
    import torch

    from gnss_bench import generator, judge, reference, stats
    from gnss_bench import trace as tracing

    notes = []
    from softgnss_tpu_torch.pipeline import run_receiver

    dev = torch.device(device)
    torch.zeros(1, device=dev)
    parts = {"process start, imports and CUDA start": process_age_s()}

    t = time.perf_counter()
    table = config_table["receiver"]
    k = int(traffic["captures"])
    scenes = [generator.draw_scene(table, traffic, seed, i) for i in range(k)]
    captures = [generator.synthesize(scene, dev) for scene in scenes]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts[f"{k} captures"] = time.perf_counter() - t

    config = receiver_config(table)
    capture_s = config.ms_to_process / 1000.0

    def job(j):
        return run_receiver(config, signal=captures[j % k], navigate=bool(traffic["navigate"]),
                            device=dev)

    for j in range(k):
        t = time.perf_counter()
        warm = job(j)
        channels = sum(1 for s in warm.tracking.status if s != "-")
        del warm
        parts[f"warm-up job {j}"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()
    setup_s = process_age_s()
    notes.append(f"gnss_bench: set-up {setup_s:.3f} s: "
                 + ", ".join(f"{part} {v:.3f} s" for part, v in parts.items()))

    # --- the window --------------------------------------------------------
    starts = [u * seconds for u in judged_starts(seed, k)]
    first, drawn, found = [None] * k, [None] * k, [False] * k
    times, timings = [], []
    failed = 0
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = stamp = time.perf_counter()
    while stamp - t0 < seconds:
        j, start = len(times), stamp - t0
        try:
            res = job(j)
        except Exception:                    # a job that fails counts, and the run goes on
            failed += 1
            notes.append("gnss_bench: job failed\n" + traceback.format_exc())
            res = None
        now = time.perf_counter()
        times.append(now - stamp)
        stamp = now
        if res is not None:
            if trace:
                timings.append(dict(res.timings_s))
            i = j % k
            if first[i] is None:
                first[i] = (j, res)
            if not found[i]:                 # the latest, until one starts at its time
                drawn[i] = (j, res)
                found[i] = start >= starts[i]
        res = None
    window_s = stamp - t0
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    notes.append(f"gnss_bench: window cpu {use1.ru_utime - use0.ru_utime:.3f} s user, "
                 f"{use1.ru_stime - use0.ru_stime:.3f} s sys, "
                 f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary and "
                 f"{use1.ru_nvcsw - use0.ru_nvcsw} voluntary switches, "
                 f"{use1.ru_minflt - use0.ru_minflt} minor faults")
    n_ok = len(times) - failed
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics: dict = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    extra: dict = {}
    if not trace:
        values = {"capture_rate": stats.rate(n_ok * capture_s, window_s),
                  "job_p90_s": stats.percentile(times, 90),
                  "setup_s": setup_s}
        for m in registry.metrics_of(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        readings = Readings(timings=timings, channels=channels, n_ms=config.ms_to_process,
                            samples_per_code=config.samples_per_code)
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for j in range(TRACED_JOBS):
                with record_function(tracing.JOB_RANGE):
                    job(j)
        readings.trace = tracing.collect(prof)
        readings.traced_jobs = TRACED_JOBS
        del prof
        for m in registry.metrics_of(bench, cell["name"], "per_layer"):
            v = registry.metric(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        lo, hi = readings.trace.window
        device_info["busy_s"] = tracing.busy_us(readings.trace) / 1e6
        device_info["window_s"] = (hi - lo) / 1e6
        extra["breakdown"] = tracing.breakdown(readings.trace)

    # --- judging, after the window and the program's state are freed ----------
    kept = [sorted({j: r for j, r in (first[i], drawn[i])}.items()) if first[i] else []
            for i in range(k)]
    del first, drawn
    judged = [(scenes[i], captures[i], [outputs_of(r) for _, r in kept[i]]) for i in range(k)]
    which = [[j for j, _ in kept[i]] for i in range(k)]
    del kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rx = reference.Receiver.from_table(table)
    numbers, distinct, why = judge.judge(rx, judged)
    notes += [f"gnss_bench: truth: {line}" for line in why]
    limits = config_table["limits"]
    every = all(which)
    correct = failed == 0 and every and judge.passes(numbers, limits)
    ts = np.asarray(times)
    notes.append(f"gnss_bench: {len(times)} jobs in {window_s:.3f} s; job s min {ts.min():.4f} "
                 f"median {np.median(ts):.4f} max {ts.max():.4f}; judged jobs {which} of "
                 f"captures 0..{k - 1} ({distinct} distinct outputs"
                 f"{'' if every else '; a capture ran no job'}); {failed} failed")
    notes.append("gnss_bench: job s in order " + " ".join(f"{v:.4f}" for v in times))
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in judge.CHECKS}
    result = {"correct": bool(correct), "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": device_info, **extra, "checks": checks}
    return CellRun(result, notes)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        bench = registry.benchmark()
        cell = registry.workload(bench, args.workload)
        config_table = registry.config(bench, cell["config"])
        traffic = registry.traffic(cell["traffic"])
    except (OSError, KeyError, ValueError) as e:
        print(f"gnss_bench: {e}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"gnss_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"gnss_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        run = run_cell(bench, cell, config_table, traffic, args.seed, args.seconds,
                       bool(args.trace))
    except ImportError as e:
        print(f"gnss_bench: the program is missing: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"gnss_bench: the process holds {bad} after the window; no result",
              file=sys.stderr)
        return 4
    for line in run.notes:
        print(line, file=sys.stderr)
    for k, v in run.result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(run.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
