"""A ``torch.profiler`` trace of one block-route tracking call, summarized
op by op on the card and on the host.

Port of ``scripts/trace_track.py``, which summed the device ops of a
JAX profiler trace of one tracking call.  On the port the host sets the
pace of the block route (its glue per 64-ms block outlasts B2 + B1 on the
card), so the summary covers both sides:

* the card: total device time over the ms tracked, then per kernel name
  its total ms, its count and its us per call (:func:`device_summary`);
* the host, on the thread that made the call: per op name (torch ops, CUDA
  API calls, and the ``softgnss/`` ranges) its self time,
  its count and its us per block; then the host time per block that falls
  inside no torch op or CUDA call (:func:`host_summary`).  The kernel
  wrappers' Python (``megakernel.launch_block``: the ``ctypes`` call and
  its argument packing) shows up there, and as the self time of the
  ``softgnss/build_frames`` and ``softgnss/track_block`` ranges that wrap
  each B2 and B1 call.

The call is ``track_segments`` on the block route (B2 + B1), as
``scan.track_on_device`` makes it, with each wrapper call inside a
``profiling.trace`` range; one untimed call runs first, as the
profiler's warm-up step.  The trace is the Chrome trace that
``torch.profiler`` writes, and every summary is a pure function of its
events (dicts with ``ph``, ``cat``, ``name``,
``pid``, ``tid``, ``ts`` and ``dur`` in us), as the JAX script read its
trace file.

Run on a CUDA card from the repository root::

    B=64 python -m softgnss_tpu_torch.scripts.trace_track

12 channels, 400 ms, ``track_block_ms`` from ``B`` (default 64).  The JAX
script's ``U`` (``track_unroll``) is a knob of the TPU layout that the port
leaves out; setting it is refused.  Without a CUDA card it raises.
"""

from __future__ import annotations

import glob
import json
import math
import os
import sys
import tempfile
import time
import warnings
from collections import defaultdict

from softgnss_tpu_torch import profiling
from softgnss_tpu_torch.config import ReceiverConfig, default_config
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track.scan import (
    _check_overflow,
    capture_words,
    channel_tables,
    initial_state,
    track_segments,
)

N_CH = 12
N_MS = 400
TOP = 30
#: the range around the traced call
WINDOW = "softgnss/trace_track"
#: Chrome-trace categories of device work, and of the host calls that count
#: as ops (what is inside none of them is the host's own Python)
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
OP_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver"})
HOST_CATS = OP_CATS | {"user_annotation"}
#: idle host seconds on each side of the traced call inside the profiled step
PAD_S = 0.01


def n_blocks(config: ReceiverConfig, n_ms: int) -> int:
    """B2 + B1 pairs of an ``n_ms`` call from ms 0 (full blocks and a tail)."""
    return -(-n_ms // max(1, config.track_block_ms))


def traced(name: str, fn):
    """``fn`` inside a ``softgnss/<name>`` range."""
    def call(*args, **kwargs):
        with profiling.trace(name):
            return fn(*args, **kwargs)

    return call


def traced_track(config, signal, tables, state, n_ms, start_ms):
    """``scan.track_on_device``'s block route with each B2 and B1 call
    inside its own range."""
    code_pads, carr_basis, active = tables
    return track_segments(config, capture_words(signal), state, code_pads, carr_basis, active,
                          n_ms, start_ms, traced("build_frames", mk.build_frames),
                          traced("track_block", mk.track_block))


def load_events(log_dir: str) -> list[dict]:
    """Every complete event (``ph`` 'X', with a ``dur``) of every
    ``*.pt.trace.json`` under ``log_dir``."""
    events = []
    for path in sorted(glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                                 recursive=True)):
        with open(path) as f:
            events += [e for e in json.load(f).get("traceEvents", [])
                       if e.get("ph") == "X" and "dur" in e]
    return events


def _runner(config: ReceiverConfig, signal, channels, n_ms: int):
    """(run, initial state): ``run(state)`` makes one :func:`traced_track`
    call of ``n_ms`` ms, checks its overflow and reads its last ms back."""
    tables = channel_tables(channels, signal.device)
    state0 = initial_state(config, channels, signal.device)

    def run(st):
        final, ys, ovf = traced_track(config, signal, tables, st, n_ms, 0)
        _check_overflow(ovf)
        float(ys.i_p[-1].sum()) + float(final.ptr.sum())

    return run, state0


def capture_trace(config: ReceiverConfig, signal, channels, n_ms: int,
                  log_dir: str | None = None) -> list[dict]:
    """The events of one ``n_ms`` tracking call (:func:`traced_track`) from
    ``channels``' initial state with its carrier phase moved by one count;
    the call, its overflow check and a read-back of its last ms inside the
    :data:`WINDOW` range.  One untimed call from the initial state runs
    first, as the profiler's warm-up step (the profiler is on, its events
    are dropped), and the traced call sits :data:`PAD_S` inside its
    profiled step on either side, off the step's edges: device events near
    the start of a trace have gone missing.  The summaries count only the
    events the trace holds.  CPU and, where there is a card, CUDA activity;
    the Chrome trace is written under ``log_dir`` (a temporary directory
    when None)."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    if log_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return capture_trace(config, signal, channels, n_ms, tmp)
    run, state0 = _runner(config, signal, channels, n_ms)
    activities = [ProfilerActivity.CPU]
    if signal.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        # the warm-up step's events are dropped on purpose
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
            run(state0)
            prof.step()
            time.sleep(PAD_S)
            with profiling.trace(WINDOW.removeprefix("softgnss/")):
                run(state0._replace(carr_phase=state0.carr_phase + 1))
            time.sleep(PAD_S)
            prof.step()
    return load_events(log_dir)


def unprofiled_s(config: ReceiverConfig, signal, channels, n_ms: int, reps: int = 3) -> float:
    """The best wall seconds of the same call as :func:`capture_trace`'s,
    without the profiler (after one untimed call): what the trace's
    window would last if tracing cost nothing."""
    run, state0 = _runner(config, signal, channels, n_ms)
    run(state0)
    best = math.inf
    for r in range(reps):
        st = state0._replace(carr_phase=state0.carr_phase + (r + 1))
        t0 = time.perf_counter()
        run(st)
        best = min(best, time.perf_counter() - t0)
    return best


def device_summary(events) -> tuple[float, dict]:
    """(total us, {kernel name: [us, count]}) of the device events."""
    rows = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            rows[e["name"]][0] += e["dur"]
            rows[e["name"]][1] += 1
    return sum(r[0] for r in rows.values()), dict(rows)


def window_event(events, window: str = WINDOW) -> dict:
    """The one host range named ``window``."""
    found = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
    if len(found) != 1:
        raise ValueError(f"expected one {window!r} event, found {len(found)}")
    return found[0]


def self_times(events) -> list[tuple[dict, float]]:
    """(event, self us) of each event: its duration less the part of it
    that its direct children on the same thread (the events that start
    inside it) cover."""
    lanes = defaultdict(list)
    for e in events:
        lanes[(e["pid"], e["tid"])].append(e)
    out = []
    for lane in lanes.values():
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []                                   # [event, end, us covered by children]
        for e in lane:
            while stack and e["ts"] >= stack[-1][1]:
                top = stack.pop()
                out.append((top[0], top[0]["dur"] - top[2]))
            if stack:
                stack[-1][2] += min(e["ts"] + e["dur"], stack[-1][1]) - e["ts"]
            stack.append([e, e["ts"] + e["dur"], 0.0])
        out += [(top[0], top[0]["dur"] - top[2]) for top in reversed(stack)]
    return out


def host_summary(events, window: str = WINDOW) -> tuple[float, dict, float]:
    """(window us, {name: [self us, count]}, us inside no op) of the host
    events on the window's thread within it, the window included: each
    name's self time (its time less its children's; the rows add up to the
    window), and the window's time that no event of :data:`OP_CATS`
    covers."""
    win = window_event(events, window)
    lo, hi = win["ts"], win["ts"] + win["dur"]
    inside = [e for e in events if e.get("cat") in HOST_CATS and e["pid"] == win["pid"]
              and e["tid"] == win["tid"] and lo <= e["ts"] < hi]
    rows = defaultdict(lambda: [0.0, 0])
    for e, us in self_times(inside):
        rows[e["name"]][0] += us
        rows[e["name"]][1] += 1
    covered, end = 0.0, lo
    for e in sorted((e for e in inside if e["cat"] in OP_CATS), key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], hi)
        if b > a:
            covered += b - a
            end = b
    return win["dur"], dict(rows), win["dur"] - covered


def report(events, config: ReceiverConfig, n_ms: int, top: int = TOP, card: str = "",
           unprofiled: float | None = None) -> list[str]:
    """The printed summary: the card's, then the host's; ``unprofiled``:
    :func:`unprofiled_s` of the same call, set beside the traced call's
    window."""
    blocks = n_blocks(config, n_ms)
    total, dev_rows = device_summary(events)
    lines = [f"[{card}] B={config.track_block_ms}: {n_ms} ms, {blocks} blocks; total device "
             f"time {total / 1e3:.3f} ms ({total / n_ms:.3f} us per ms)"]
    for name, (us, n) in sorted(dev_rows.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"{us / 1e3:9.3f} ms  n={n:6d}  {us / max(n, 1):8.2f} us/call  "
                     f"{name[:110]}")
    win_us, host_rows, outside = host_summary(events)
    bare = "" if unprofiled is None else (
        f" (without the profiler {unprofiled * 1e3:.3f} ms, {unprofiled * 1e6 / blocks:.1f} us "
        "per block)")
    lines.append(f"[{card}] host, the calling thread: {win_us / 1e3:.3f} ms in the call, "
                 f"{win_us / blocks:.1f} us per block{bare}; inside no op "
                 f"{outside / blocks:.1f} us per block ({outside / win_us:.4f} of the call)")
    for name, (us, n) in sorted(host_rows.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"{us / 1e3:9.3f} ms self  n={n:6d} ({n / blocks:6.2f} per block)  "
                     f"{us / blocks:8.2f} us/block  {name[:100]}")
    return lines


def main(argv=None) -> int:
    from softgnss_tpu_torch.scripts.inputs import sweep_inputs
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    if "U" in os.environ:
        raise SystemExit("U (track_unroll) is a knob of the TPU layout that the port leaves "
                         "out; unset it")
    dev = require_cuda()
    cfg = default_config(number_of_channels=N_CH, correlator_impl="megakernel",
                         track_block_ms=int(os.environ.get("B", "64")))
    inputs = sweep_inputs(cfg, N_CH, N_MS, dev, phase0=False)
    events = capture_trace(cfg, inputs.signal, inputs.channels, N_MS)
    bare = unprofiled_s(cfg, inputs.signal, inputs.channels, N_MS)
    print("\n".join(report(events, cfg, N_MS, card=card(), unprofiled=bare)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
