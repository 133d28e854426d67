"""The port's route measurements (softgnss_tpu_torch.scripts: profile_track,
mega_sweep, trace_track, glue_trace, fullscale_loop) on the CPU.

The JAX scripts of those names run at import, so these tests call the JAX
package's functions that they wrap (``_track_device`` and the
synthesizer) on the same NumPy capture, and copy the scripts' own recipes
and formulas where a port function stands for them: the satellites each
script draws, the JAX profile_track formula of the marginal cost, and
glue_trace's aggregation of trace events.  On the CPU every route runs its
kernels' plain versions.

Tolerances: against JAX 'gather' those of tests/test_tracking.py::
test_onehot_matches_gather_impl (correlators 1e-4 of their RMS,
carr_freq 1e-6 Hz, absolute_sample equal); the noise-free capture that of
tests/test_torch_signals.py::test_synth_noise_free_matches; the sweep
points, the fused route and the warm run bit-equal.

The ``gpu`` tests hold each route on a card against its plain version; they
import no JAX, so they also run on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_sweeps.py
"""

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.scripts import fullscale_loop as fl
from softgnss_tpu_torch.scripts import glue_trace as gt
from softgnss_tpu_torch.scripts import mega_sweep as ms
from softgnss_tpu_torch.scripts import profile_track as pt
from softgnss_tpu_torch.scripts import trace_track as tt
from softgnss_tpu_torch.scripts.inputs import sweep_inputs
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import scan as tscan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_CH = 4
N_SHORT, N_LONG = 32, 80
_CORR = ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")
#: (phase0, nav_bits) drawn by each JAX script
RECIPES = {"profile_track": (True, True), "mega_sweep": (True, False),
           "trace_track": (False, True), "glue_trace": (False, False)}
NEW_SCRIPTS = ("profile_track", "mega_sweep", "trace_track", "glue_trace", "fullscale_loop",
               "warmup_sweep")


def _cfg(**kw):
    return sgt.fast_config(number_of_channels=N_CH, track_block_ms=16, **kw)


def _jax_sats(script: str, spc: int, n_ch: int):
    """The satellites each JAX script builds (their lines, copied)."""
    from softgnss_tpu.signals.synth import SatelliteSignal

    rng = np.random.default_rng(42)
    prns = list(range(1, n_ch + 1))
    if script == "profile_track":           # scripts/profile_track.py:36-43
        return [SatelliteSignal(prn=p,
                                doppler_hz=float(rng.uniform(-4000, 4000)),
                                delay_samples=float(rng.integers(0, spc)),
                                phase0=float(rng.uniform(0, 6.28)),
                                nav_bits=tuple(rng.choice([-1, 1], size=64)))
                for p in prns]
    if script == "mega_sweep":              # scripts/mega_sweep.py:29-32
        return [SatelliteSignal(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                                delay_samples=float(rng.integers(0, spc)),
                                phase0=float(rng.uniform(0, 6.28)))
                for p in prns]
    if script == "trace_track":             # scripts/trace_track.py:33-36
        return [SatelliteSignal(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                                delay_samples=float(rng.integers(0, spc)),
                                nav_bits=tuple(rng.choice([-1, 1], size=64)))
                for p in prns]
    return [SatelliteSignal(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),   # glue_trace.py:15-17
                            delay_samples=float(rng.integers(0, spc)))
            for p in prns]


# --- inputs.sweep_inputs -------------------------------------------------------


@pytest.mark.parametrize("script", list(RECIPES))
def test_sweep_inputs_draw_each_jax_recipe(script):
    """PRNs, Doppler, delays, phase0 and nav bits equal to the JAX script's
    at the same seed, at the reference front end and 12 channels; the
    channels at that truth."""
    phase0, nav_bits = RECIPES[script]
    cfg = sgt.default_config(number_of_channels=12)
    got = sweep_inputs(cfg, 12, 1, "cpu", phase0=phase0, nav_bits=nav_bits)
    want = _jax_sats(script, cfg.samples_per_code, 12)
    for a, b in zip(got.sats, want, strict=True):
        assert (a.prn, a.doppler_hz, a.delay_samples, a.phase0) == \
            (b.prn, b.doppler_hz, b.delay_samples, b.phase0)
        assert (a.nav_bits is None) == (b.nav_bits is None)
        if a.nav_bits is not None:
            assert list(a.nav_bits) == [int(x) for x in b.nav_bits]
    np.testing.assert_array_equal(got.channels.prn, np.arange(1, 13))
    np.testing.assert_array_equal(got.channels.acquired_freq,
                                  [cfg.intermediate_freq + s.doppler_hz for s in want])
    np.testing.assert_array_equal(got.channels.code_phase, [int(s.delay_samples) for s in want])
    assert got.channels.status == ["T"] * 12
    assert got.signal.shape == (4 * cfg.samples_per_code,)


@pytest.mark.parametrize("script", ["profile_track", "glue_trace"])
def test_sweep_inputs_noise_free_capture_matches_jax_synth(script):
    import softgnss_tpu as sg
    from softgnss_tpu.signals.synth import synthesize_signal

    phase0, nav_bits = RECIPES[script]
    cfg = _cfg()
    got = sweep_inputs(cfg, 8, 37, "cpu", phase0=phase0, nav_bits=nav_bits, noise_std=0.0)
    jc = sg.fast_config(number_of_channels=N_CH, track_block_ms=16)
    want = synthesize_signal(jc, _jax_sats(script, jc.samples_per_code, 8), 40,
                             noise_std=0.0, seed=9)
    assert got.signal.dtype == torch.int8 and got.signal.shape == want.shape
    d = got.signal.numpy().astype(np.int16) - want
    assert np.abs(d).max() <= 1
    assert np.mean(d != 0) <= 1e-4


# --- profile_track -----------------------------------------------------------


@pytest.fixture(scope="module")
def routes():
    """profile_track's recipe at the fast front end: the JAX synthesizer's
    capture, the port's three routes through time_route (outputs of each
    length's untimed call) and JAX _track_device on 'gather' over N_LONG ms."""
    import jax
    import jax.numpy as jnp

    import softgnss_tpu as sg
    from softgnss_tpu.acquire.search import Channels as JChannels
    from softgnss_tpu.signals.synth import synthesize_signal
    from softgnss_tpu.track.scan import _track_device, initial_state
    from softgnss_tpu.track.tables import build_tables

    cfg = _cfg()
    jc = sg.fast_config(number_of_channels=N_CH, track_block_ms=16, correlator_impl="gather")
    sats = _jax_sats("profile_track", jc.samples_per_code, N_CH)
    signal = np.asarray(synthesize_signal(jc, sats, N_LONG + 3, noise_std=1.0, seed=9))
    channels = sweep_inputs(cfg, N_CH, 1, "cpu").channels
    sig = torch.from_numpy(signal.copy())
    outs, times = {}, {}
    for text in pt.DEFAULT_SPECS:
        spec = "16" + text[2:] if text.startswith("64") else text
        c = pt.spec_config(cfg, pt.parse_spec(spec))
        times[text] = pt.time_route(
            c, sig, channels, N_SHORT, N_LONG, reps=1,
            check=lambda n, final, ys, text=text: outs.__setitem__((text, n), (final, ys)))
    jch = JChannels(prn=channels.prn.copy(), acquired_freq=channels.acquired_freq.copy(),
                    code_phase=channels.code_phase.copy(), status=list(channels.status))
    tables = build_tables(jc, np.asarray(jch.prn), np.asarray(jch.acquired_freq))
    _, ys, _ = _track_device(jc, jnp.asarray(signal), jax.tree.map(jnp.asarray, tables),
                             jnp.asarray(jch.acquired_freq, jnp.float64),
                             jnp.asarray(np.ones(N_CH, bool)), N_LONG, initial_state(jc, jch))
    ref = {f: np.asarray(getattr(ys, f)) for f in ys._fields}
    return outs, times, ref


@pytest.mark.parametrize("text", pt.DEFAULT_SPECS)
def test_time_route_matches_jax_gather(routes, text):
    """Each route's N_LONG-ms outputs against JAX _track_device on 'gather'
    (tests/test_tracking.py:165-176's tolerances), and its N_SHORT-ms call
    a prefix of them."""
    outs, _, ref = routes
    _, ys = outs[(text, N_LONG)]
    got = {f: getattr(ys, f).numpy() for f in tscan.MsOutputs._fields}
    np.testing.assert_array_equal(got["absolute_sample"], ref["absolute_sample"])
    for key in _CORR:
        a, b = got[key], ref[key]
        assert np.max(np.abs(a - b)) / np.sqrt(np.mean(b ** 2)) < 1e-4, key
    np.testing.assert_allclose(got["carr_freq"], ref["carr_freq"], atol=1e-6)
    _, short = outs[(text, N_SHORT)]
    for f, v in zip(tscan.MsOutputs._fields, short):
        assert torch.equal(v, getattr(ys, f)[:N_SHORT]), f


def test_fused_route_bit_equal_to_block(routes):
    outs, _, _ = routes
    for n in (N_SHORT, N_LONG):
        for f, a, b in zip(tscan.MsOutputs._fields, outs[("64,fused", n)][1], outs[("64", n)][1]):
            assert torch.equal(a, b), (n, f)


@pytest.mark.parametrize("text", pt.DEFAULT_SPECS)
def test_time_route_marginal_cost_formula(routes, text):
    """The JAX script's per_ms = (T_long - T_short) / (N_LONG - N_SHORT)
    (scripts/profile_track.py:87) on the returned times."""
    _, times, _ = routes
    ts, per_ms = times[text]
    assert set(ts) == {N_SHORT, N_LONG} and all(t > 0 for t in ts.values())
    assert per_ms == (ts[N_LONG] - ts[N_SHORT]) / (N_LONG - N_SHORT)


def test_time_route_refuses_bad_lengths():
    cfg = _cfg()
    inp = sweep_inputs(cfg, 2, 20, "cpu")
    with pytest.raises(ValueError, match="n_short < n_long"):
        pt.time_route(cfg, inp.signal, inp.channels, 20, 20, reps=0)
    with pytest.raises(ValueError, match="capture too short"):
        pt.time_route(cfg, inp.signal, inp.channels, 10, 40, reps=0)


@pytest.mark.parametrize("text, want", [
    ("1", (1, 0, False)), ("64", (64, 0, False)), ("64,fused", (64, 0, True)),
    ("128,300", (128, 300, False)), ("128,300,fused", (128, 300, True))])
def test_parse_spec(text, want):
    spec = pt.parse_spec(text)
    assert tuple(spec) == want
    cfg = pt.spec_config(_cfg(), spec)
    assert cfg.tracker == ("per_ms" if want[0] == 1 else "block")
    if want[0] > 1:
        assert (cfg.track_block_ms, cfg.track_frame_margin, cfg.mega_fused_frames) == want


@pytest.mark.parametrize("text", ["64,1,0", "64,1,0,2", "1,1,0,2", "1,fused", "x", "64,fast"])
def test_parse_spec_refuses_tpu_knobs_and_junk(text):
    """The JAX spec B,unroll,margin,pack: unroll and pack are TPU layout
    knobs the port leaves out."""
    with pytest.raises(ValueError, match="spec"):
        pt.parse_spec(text)


# --- mega_sweep --------------------------------------------------------------


def test_mega_sweep_points_bit_equal():
    """Two block sizes x two cluster sizes, each point's outputs bit-equal
    to the reference point's at both lengths (sweep raises otherwise), each
    timed."""
    cfg = _cfg()
    inp = sweep_inputs(cfg, N_CH, N_LONG, "cpu", nav_bits=False)
    lines = []
    points = ((8, 4), (16, 16), (8, 16), (16, 2))
    out = ms.sweep(cfg, inp.signal, inp.channels, points, reference=(16, 16), n_short=N_SHORT,
                   n_long=N_LONG, reps=1, report=lines.append)
    assert list(out) == list(points)
    assert all(not isinstance(v, str) and v[1] > -np.inf for v in out.values())
    assert len(lines) == 4 and all("bit-equal to (16, 16)" in line for line in lines)


def test_mega_sweep_catches_a_point_that_differs(monkeypatch):
    """The bit-equality check fails a point whose outputs move by one ulp."""
    cfg = _cfg()
    inp = sweep_inputs(cfg, 2, N_LONG, "cpu", nav_bits=False)
    point_track = ms.point_track

    def off_by_an_ulp(kn):
        track = point_track(kn)
        if kn != 2:
            return track

        def moved(*args):
            final, ys, ovf = track(*args)
            return final, ys._replace(i_p=torch.nextafter(ys.i_p, ys.i_p + 1)), ovf

        return moved

    monkeypatch.setattr(ms, "point_track", off_by_an_ulp)
    with pytest.raises(AssertionError, match="i_p differs"):
        ms.sweep(cfg, inp.signal, inp.channels, ((16, 4), (16, 2)), reference=(16, 16),
                 n_short=N_SHORT, n_long=N_LONG, reps=0, report=lambda line: None)


def test_mega_sweep_overflowing_point_raises():
    """At a 2-sample frame margin a 512-ms block outgrows its frames (the
    code Doppler drifts past the slack); the sweep raises, it does not skip."""
    cfg = sgt.fast_config(number_of_channels=N_CH, track_frame_margin=2)
    inp = sweep_inputs(cfg, N_CH, 512, "cpu", nav_bits=False)
    with pytest.raises(RuntimeError, match="overflowed"):
        ms.sweep(cfg, inp.signal, inp.channels, ((16, 4), (512, 4)), reference=(16, 16),
                 n_short=64, n_long=512, reps=0, report=lambda line: None)


def test_mega_sweep_points_are_the_jax_points_scaled():
    """The JAX points (64,38) (64,76) (128,38) (128,76) (256,76) (64,19)
    with 76 tiles as the default 16 CTAs per channel."""
    jax_points = [(64, 38), (64, 76), (128, 38), (128, 76), (256, 76), (64, 19)]
    assert ms.POINTS == tuple((b, k * mk.CTAS_PER_CHANNEL // 76) for b, k in jax_points)
    assert ms.REFERENCE == (64, mk.CTAS_PER_CHANNEL)
    assert ms.parse_point("128,8") == (128, 8)
    for bad in ("128", "128,3", "1,8", "a,b"):
        with pytest.raises(ValueError):
            ms.parse_point(bad)
    assert ms.refusal(_cfg(), "cpu", 16) is None


# --- trace_track and glue_trace ----------------------------------------------


def _jax_glue_aggregate(trace_events):
    """scripts/glue_trace.py:46-54, copied (the events of one trace file)."""
    import collections

    ev = []
    for e in trace_events:
        if e.get('ph') == 'X' and 'dur' in e:
            ev.append((e.get('pid'), e.get('name', ''), e['dur']))
    agg = collections.Counter()
    for pid, name, dur in ev:
        agg[name] += dur
    return agg


FIXED_EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "host"}},
    {"ph": "X", "cat": "user_annotation", "name": "softgnss/trace_track", "pid": 1, "tid": 7,
     "ts": 1000.0, "dur": 100.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::stack", "pid": 1, "tid": 7, "ts": 1010.0,
     "dur": 20.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 7,
     "ts": 1015.0, "dur": 5.0},
    {"ph": "X", "cat": "user_annotation", "name": "softgnss/track_block", "pid": 1, "tid": 7,
     "ts": 1040.0, "dur": 50.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::stack", "pid": 1, "tid": 7, "ts": 1050.0,
     "dur": 10.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1, "tid": 9, "ts": 1050.0,
     "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "track_block_kernel", "pid": 0, "tid": 7, "ts": 1020.0,
     "dur": 400.0},
    {"ph": "X", "cat": "kernel", "name": "build_frames_kernel", "pid": 0, "tid": 7,
     "ts": 1012.0, "dur": 8.0},
    {"ph": "X", "cat": "kernel", "name": "track_block_kernel", "pid": 0, "tid": 7, "ts": 1500.0,
     "dur": 390.0},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "softgnss/trace_track", "pid": 0,
     "tid": 7, "ts": 1012.0, "dur": 900.0},
    {"ph": "X", "name": "no duration", "pid": 1, "tid": 7, "ts": 1.0},
    {"ph": "i", "name": "instant", "pid": 1, "tid": 7, "ts": 1.0, "dur": 3.0},
]


def test_summaries_of_a_fixed_event_list():
    total, dev = tt.device_summary(FIXED_EVENTS)
    assert total == 798.0 and sum(us for us, _ in dev.values()) == total
    assert dev == {"track_block_kernel": [790.0, 2], "build_frames_kernel": [8.0, 1]}
    win_us, rows, outside = tt.host_summary(FIXED_EVENTS)
    # the window's thread only: the other thread's aten::empty is not counted
    assert rows == {"softgnss/trace_track": [30.0, 1], "aten::stack": [25.0, 2],
                    "cudaLaunchKernel": [5.0, 1], "softgnss/track_block": [40.0, 1]}
    assert win_us == 100.0 and sum(us for us, _ in rows.values()) == win_us
    assert outside == 100.0 - 20.0 - 10.0


#: the bulk design's device name as a profiler shows it
BULK_NAME = ("void (anonymous namespace)::build_frames_bulk_kernel<true>(int const*, long long, "
             "long long const*, int*, int, int, int, long long, int, int)")


def test_summaries_name_the_bulk_frames_kernel():
    """The fixed event list with B2's event under the bulk design's name:
    the device summary keeps it, and it counts as B2 (mk.is_frames_kernel),
    as chip_smoke.py's shares and loop spans read it; B1 never does."""
    events = [dict(e, name=BULK_NAME) if e["name"] == "build_frames_kernel" else e
              for e in FIXED_EVENTS]
    total, dev = tt.device_summary(events)
    assert total == 798.0 and dev[BULK_NAME] == [8.0, 1]
    assert sum(n for name, (_, n) in dev.items() if mk.is_frames_kernel(name)) == 1
    assert sum(us for name, (us, _) in dev.items() if mk.is_frames_kernel(name)) == 8.0
    assert mk.is_frames_kernel(BULK_NAME)
    assert not mk.is_frames_kernel("track_block_kernel")


def test_glue_aggregate_matches_the_jax_formula():
    assert gt.aggregate(FIXED_EVENTS) == _jax_glue_aggregate(FIXED_EVENTS)
    assert gt.aggregate(FIXED_EVENTS)["track_block_kernel"] == 790.0


def test_self_times_partition_nested_events():
    ev = [dict(name=n, pid=1, tid=1, ts=float(a), dur=float(b - a))
          for n, a, b in (("p", 0, 100), ("c1", 10, 30), ("c2", 40, 90), ("g", 50, 60),
                          ("next", 100, 120))]
    got = {e["name"]: us for e, us in tt.self_times(ev)}
    assert got == {"p": 30.0, "c1": 20.0, "c2": 40.0, "g": 10.0, "next": 20.0}


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """trace_track's trace of 56 ms (four 16-ms blocks, the last a tail) of
    the plain block route, and the trace file it wrote."""
    cfg = _cfg()
    inp = sweep_inputs(cfg, 2, 56, "cpu", phase0=False)
    log_dir = tmp_path_factory.mktemp("trace")
    return cfg, tt.capture_trace(cfg, inp.signal, inp.channels, 56, str(log_dir)), log_dir


def test_trace_summary_of_a_cpu_profile(cpu_trace):
    """On the plain block route: one B2 and one B1 range per block, the
    host rows add up to the call, the time inside no op is part of it; no
    device events on the CPU."""
    cfg, events, log_dir = cpu_trace
    assert list(log_dir.glob("*.pt.trace.json"))
    blocks = tt.n_blocks(cfg, 56)
    assert blocks == 4
    win_us, rows, outside = tt.host_summary(events)
    assert rows["softgnss/build_frames"][1] == blocks
    assert rows["softgnss/track_block"][1] == blocks
    assert rows[tt.WINDOW][1] == 1
    assert sum(us for us, _ in rows.values()) == pytest.approx(win_us, rel=1e-6, abs=1.0)
    assert 0.0 < outside < win_us
    assert tt.device_summary(events) == (0.0, {})
    lines = tt.report(events, cfg, 56, top=5, card="cpu")
    assert "4 blocks" in lines[0] and "inside no op" in lines[1] and len(lines) == 7


def test_glue_aggregate_of_a_cpu_profile(cpu_trace):
    """The JAX formula on the trace file's own events equals the port's
    aggregation; the window covers its ranges."""
    import json

    _, events, log_dir = cpu_trace
    raw = []
    for path in log_dir.glob("*.pt.trace.json"):
        raw += json.loads(path.read_text())["traceEvents"]
    agg = gt.aggregate(events)
    assert agg == _jax_glue_aggregate(raw)
    assert agg[tt.WINDOW] >= agg["softgnss/track_block"] + agg["softgnss/build_frames"]
    assert gt.report(events, 56, top=3)[1].endswith(Counter(agg).most_common(1)[0][0][:100])


# --- fullscale_loop ----------------------------------------------------------


@pytest.fixture(scope="module")
def fullscale_case():
    from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario

    cfg = sgt.fast_config(number_of_channels=4)
    sc = build_scenario(cfg, n_sats=4)
    sig = synthesize_scenario(sc, 300 + cfg.acquisition_ms + 2, device="cpu")
    lines = []
    out = fl.fullscale(cfg, sig, sc, n_ms=300, navigate=False, report=lines.append)
    return cfg, sig, sc, out, lines


def test_fullscale_cold_and_warm_bit_equal(fullscale_case):
    _, _, _, out, lines = fullscale_case
    cold, warm = out["cold"], out["warm"]
    assert cold is not warm and cold.tracking.n_ms == 300
    for f in fl.TRACK_FIELDS:
        np.testing.assert_array_equal(getattr(warm.tracking, f), getattr(cold.tracking, f))
    assert out["cold_wall_s"] > 0 and out["warm_wall_s"] > 0
    assert lines[0].startswith("COLD: wall") and lines[1].startswith("WARM: wall")
    assert "bit-equal" in lines[1] and "track" in lines[1]


def test_fullscale_warm_half_and_its_check(fullscale_case):
    """With ``cold=`` only the warm run runs; a warm run that differs from
    the cold one by an ulp, or in its fixes, raises."""
    cfg, sig, sc, out, _ = fullscale_case
    lines = []
    again = fl.fullscale(cfg, sig, sc, n_ms=300, navigate=False, cold=out["cold"],
                         report=lines.append)
    assert again["cold"] is out["cold"] and again["cold_wall_s"] is None and len(lines) == 1
    moved = out["warm"].tracking.i_p.copy()
    moved[0, 7] = np.nextafter(moved[0, 7], np.float32(np.inf))
    other = type(out["warm"])(**{**out["warm"].__dict__})
    other.tracking = type(out["warm"].tracking)(**{**out["warm"].tracking.__dict__, "i_p": moved})
    with pytest.raises(AssertionError, match="i_p differs"):
        fl.assert_same(out["cold"], other, navigate=False)
    with pytest.raises(AssertionError, match="no navigation solution"):
        fl.assert_same(out["cold"], type(other)(**{**other.__dict__, "tracking": out[
            "warm"].tracking, "solutions": object()}), navigate=True)


# --- entry points ------------------------------------------------------------


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_script_exits_nonzero_without_cuda(name):
    """No fallback: without a CUDA card each script raises before it
    measures or prints anything."""
    proc = subprocess.run([sys.executable, "-m", f"softgnss_tpu_torch.scripts.{name}"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert proc.stdout == ""


def test_new_scripts_import_no_jax():
    """With jax and the JAX package made unimportable, the six scripts and
    chip_smoke.py import."""
    mods = ", ".join(f"softgnss_tpu_torch.scripts.{n}" for n in NEW_SCRIPTS)
    code = ("import sys; sys.modules['jax'] = None; sys.modules['softgnss_tpu'] = None\n"
            f"import {mods}, chip_smoke\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'softgnss_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scripts are also run by chip_smoke.py)")
    return torch.device("cuda")


def _plain_track(config, signal, tables, state, n_ms, start_ms):
    """scan.track_on_device with every kernel's plain version."""
    from softgnss_tpu_torch.track import pallas_kernel as pk

    code_pads, carr_basis, active = tables
    if config.tracker == "per_ms":
        final, ys = tscan.track_ms(config, signal, state, code_pads, carr_basis, active, n_ms,
                                   start_ms, pk.correlate_ms_plain)
        return final, ys, torch.zeros_like(final.ptr)
    build, block = ((None, mk.track_block_fused_plain) if config.mega_fused_frames
                    else (mk.build_frames_plain, mk.track_block_plain))
    return tscan.track_segments(config, tscan.capture_words(signal), state, code_pads,
                                carr_basis, active, n_ms, start_ms, build, block)


@pytest.mark.gpu
@pytest.mark.parametrize("text", pt.DEFAULT_SPECS)
def test_time_route_kernels_match_plain_on_card(cuda_device, text):
    """Each route's outputs on the card bit-equal to its plain version's on
    the same card tensors, at 12 channels of the reference front end."""
    base = sgt.default_config(number_of_channels=12)
    cfg = pt.spec_config(base, pt.parse_spec(text))
    inp = sweep_inputs(base, 12, 96, cuda_device)
    got, want = {}, {}
    pt.time_route(cfg, inp.signal, inp.channels, 32, 96, reps=1,
                  check=lambda n, final, ys: got.__setitem__(n, ys._asdict()))
    pt.time_route(cfg, inp.signal, inp.channels, 32, 96, reps=0, track=_plain_track,
                  check=lambda n, final, ys: want.__setitem__(n, ys._asdict()))
    from softgnss_tpu_torch.scripts.inputs import assert_bit_equal

    for n in (32, 96):
        assert_bit_equal(f"{text} at {n} ms", got[n], want[n])


@pytest.mark.gpu
def test_mega_sweep_on_card(cuda_device):
    base = sgt.default_config(number_of_channels=12)
    inp = sweep_inputs(base, 12, 256, cuda_device, nav_bits=False)
    out = ms.sweep(base, inp.signal, inp.channels, ((64, 4), (128, 8), (64, 16)),
                   n_short=64, n_long=256, reps=1, report=lambda line: None)
    assert all(not isinstance(v, str) for v in out.values())


@pytest.mark.gpu
def test_trace_records_the_kernels_on_card(cuda_device):
    cfg = sgt.default_config(number_of_channels=12, correlator_impl="megakernel")
    inp = sweep_inputs(cfg, 12, 200, cuda_device, phase0=False)
    events = tt.capture_trace(cfg, inp.signal, inp.channels, 200)
    _, dev = tt.device_summary(events)
    blocks = tt.n_blocks(cfg, 200)
    assert sum(n for name, (_, n) in dev.items() if "track_block_kernel" in name) == blocks
    assert sum(n for name, (_, n) in dev.items() if mk.is_frames_kernel(name)) == blocks
