"""The port's spans and counters inside a job: ``trace()`` regions inside a
``StageTimer`` stage land in ``timings_s`` as ``<stage>.<part>`` host times
without waiting for the device, and ``track_segments`` counts its calls,
the segments they issue and, on the card, the blocks graph replays issue
(none on the CPU)."""

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch import profiling
from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.profiling import StageTimer, trace
from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch.track.scan import track, track_segments

torch.set_num_threads(1)

PARTS = {"acquire": ("acquire.tables", "acquire.wait"),
         "track": ("track.loop", "track.wait", "track.to_host", "track.demote")}


@pytest.fixture(scope="module")
def job():
    """One receiver job on the CPU: 2 satellites, 200 ms at 64-ms blocks
    (three full blocks and a tail)."""
    cfg = sgt.fast_config(number_of_channels=4)
    sats = [SatelliteSignal(prn=12, doppler_hz=2100.0, delay_samples=777.0),
            SatelliteSignal(prn=29, doppler_hz=-3300.0, delay_samples=3001.0)]
    sig = synthesize_signal(cfg, sats, 320, noise_std=2.0, seed=42, device="cpu")
    before = _counters()
    res = run_receiver(cfg, signal=sig, n_ms=200, navigate=False, device="cpu")
    return cfg, sig, res, tuple(a - b for a, b in zip(_counters(), before))


def _counters():
    return track_segments.calls, track_segments.segments, track_segments.graph_blocks


def test_a_job_holds_each_stage_and_its_parts(job):
    res = job[2]
    assert set(res.timings_s) == {k for stage, parts in PARTS.items()
                                  for k in (stage,) + parts}
    assert list(res.timings_s)[:1] == ["acquire"]          # a stage before its parts


@pytest.mark.parametrize("stage", sorted(PARTS))
def test_the_parts_of_a_stage_fit_inside_it(job, stage):
    t = job[2].timings_s
    assert all(t[p] >= 0.0 for p in PARTS[stage])
    assert sum(t[p] for p in PARTS[stage]) <= t[stage]


def test_a_job_counts_one_call_and_its_segments(job):
    cfg = job[0]
    assert cfg.track_block_ms == 64
    assert job[3] == (1, 4, 0)                      # 64, 64, 64, then 8; no graph on the CPU


@pytest.mark.parametrize("first_ms,then_ms,segments", [
    (100, 100, (2, 3)),       # full + 36-ms tail; then a 28-ms lead, a full block, an 8-ms tail
    (128, 64, (2, 1)),        # two full blocks; then one full block on the grid
    (30, 34, (1, 1)),         # a tail alone; then the lead that finishes its block
])
def test_the_counters_follow_the_plan(job, first_ms, then_ms, segments):
    cfg, sig, res, _ = job
    got = []
    state = None
    for n in (first_ms, then_ms):
        before = _counters()
        out = track(cfg, sig, res.channels, n_ms=n, state=state, device="cpu")
        state = out.final_state
        calls, segs, graph_blocks = (a - b for a, b in zip(_counters(), before))
        assert (calls, graph_blocks) == (1, 0)
        got.append(segs)
    assert tuple(got) == segments


def test_a_span_never_waits_for_the_device(job, monkeypatch):
    """Inside a stage on the card the stage's own two syncs are the only
    ones; a CPU job under a synchronize that raises runs through."""
    cfg, sig, _, _ = job
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    timer = StageTimer("cuda")
    with timer.stage("s"):
        assert len(syncs) == 1
        for part in ("s.a", "s.b", "s.a"):
            with trace(part):
                sum(range(100))
        assert len(syncs) == 1
    assert len(syncs) == 2
    assert set(timer.timings_s) == {"s", "s.a", "s.b"}
    assert timer.timings_s["s.a"] + timer.timings_s["s.b"] <= timer.timings_s["s"]

    def refuse(*a):
        raise AssertionError("a span synchronized the device")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    res = run_receiver(cfg, signal=sig, n_ms=100, navigate=False, device="cpu")
    assert "track.wait" in res.timings_s


def test_a_span_outside_a_stage_records_nothing():
    timer = StageTimer("cpu")
    with trace("loose"):
        pass
    with timer.stage("s"):
        pass
    with trace("after"):
        pass
    assert set(timer.timings_s) == {"s"}
    assert profiling._CURRENT.get() is None


def test_a_stage_that_raises_ends_its_span():
    timer = StageTimer("cpu")
    with pytest.raises(ValueError):
        with timer.stage("s"):
            with trace("s.part"):
                raise ValueError("inside")
    assert set(timer.timings_s) == {"s", "s.part"}
    assert profiling._CURRENT.get() is None
    assert np.isfinite(timer.timings_s["s"])
