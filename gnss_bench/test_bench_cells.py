"""CPU tests that drive whole runs of a cell at a small front end (4.096 MHz,
600 ms, the receiver's plain PyTorch versions): the generator and the
reference hold on a sound run, the float32 control and each fault the cell
can have come out as not correct, the harness loads no JAX, and the
command exits without a result where it has no card or no program.  One
test needs the card and skips here.
Run: python -m pytest gnss_bench -p no:cacheprovider"""

from __future__ import annotations

import copy
import gc
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnss_bench import control, judge, registry, run

ROOT = Path(__file__).resolve().parent.parent
SEED = 2_147_483_659          # past 32 signed bits: seeds may be that large
#: the small front end; 128-ms chunks, so that a streamed job cuts five
SMALL = {"sampling_freq": 4_096_000.0, "intermediate_freq": 1_000_000.0, "ms_to_process": 600,
         "track_stream_chunk_ms": 128}
STREAM_CHUNKS = 5
#: the streamed route: ``ref38`` under ``obs``'s draw with ``stream`` set, a
#: mix that no cell of BENCHMARK.json holds (its runs on the card spread
#: past the bounds, PERF.md)
STREAMED = "ref38.stream"


def small_cell(name="ref38.obs", captures=1):
    """The cell at the small front end; ``captures`` distinct captures (a
    job takes seconds on the CPU, so most tests cycle through one)."""
    bench = registry.benchmark(ROOT)
    streamed = name == STREAMED
    cell = ({"name": name, "config": "ref38", "traffic": "obs", "chips": 1} if streamed
            else registry.workload(bench, name))
    cfg = copy.deepcopy(registry.config(bench, cell["config"], ROOT))
    cfg["receiver"].update(SMALL)
    traffic = dict(registry.traffic(cell["traffic"]), captures=captures,
                   **({"stream": True} if streamed else {}))
    return bench, cell, cfg, traffic


def small_run(seconds=0.5, trace=False, seed=SEED, captures=1, name="ref38.obs"):
    bench, cell, cfg, traffic = small_cell(name, captures=captures)
    try:
        return run.run_cell(bench, cell, cfg, traffic, seed, seconds, trace, device="cpu")
    finally:
        gc.unfreeze()                        # run_cell freezes what set-up made


def test_sound_run_is_correct_and_reports_its_metrics():
    run_ = small_run(seconds=15.0, captures=3)       # a job takes 2-5 s on a CPU
    r = run_.result
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert not any("ran no job" in n for n in run_.notes)
    assert set(r["metrics"]) == {"capture_rate", "job_p90_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    checks = r["checks"]
    assert list(checks) == list(judge.CHECKS)
    for k in ("acq_mismatch", "sample_mismatch", "status_mismatch", "truth_mismatch"):
        assert checks[k]["value"] == 0
    assert checks["corr_rel"]["value"] < 1e-5
    assert checks["carr_freq_hz"]["value"] < 1e-3


def test_each_capture_has_a_judged_job_in_its_own_part_of_the_window():
    for seed in (1, SEED, 2**31 + 99):
        starts = run.judged_starts(seed, 3)
        assert all(i / 3 <= u < (i + 1) / 3 for i, u in enumerate(starts))
    assert run.judged_starts(SEED, 3) == run.judged_starts(SEED, 3)
    assert run.judged_starts(SEED, 3) != run.judged_starts(SEED + 1, 3)


def test_a_window_that_misses_a_capture_is_not_correct():
    r = small_run(seconds=0.1, captures=3).result
    assert r["attempted"] < 3 and not r["correct"]


#: per-layer metrics that read nothing on the CPU beside the device-trace
#: ones: B1 and B3 launch no kernel there
NO_LAUNCH = {"track_short_path_share"}


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    r = small_run(trace=True).result
    assert r["correct"], r["checks"]
    entries = registry.metrics_of(registry.benchmark(ROOT), "ref38.obs", "per_layer")
    # no card here: the device-trace readers find nothing and are left out
    want = {m["name"] for m in entries if m["source"] != "device_trace"} - NO_LAUNCH
    assert set(r["metrics"]) == want
    assert all(v["value"] >= 0 for v in r["metrics"].values())
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0


def test_a_streamed_run_is_correct_and_cuts_chunks(monkeypatch):
    """The streamed mix at the small front end: every job tracks through
    parallel.stream in 128-ms chunks (on the CPU without the card's upload),
    and the judge finds its outputs correct."""
    from softgnss_tpu_torch.parallel import stream

    chunks, calls = [], []
    orig_chunk, orig_streamed = stream.track_on_device, stream.track_streamed

    def on_device(*a, **k):
        chunks.append(a[4])
        return orig_chunk(*a, **k)

    def streamed(*a, **k):
        calls.append(len(chunks))
        return orig_streamed(*a, **k)
    monkeypatch.setattr(stream, "track_on_device", on_device)
    monkeypatch.setattr("softgnss_tpu_torch.pipeline.track_streamed", streamed)
    run_ = small_run(seconds=1.0, name=STREAMED)
    r = run_.result
    assert r["correct"], (r["checks"], run_.notes[-3:])
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"capture_rate", "job_p90_s", "setup_s"}
    jobs = 1 + r["attempted"]                        # the warm-up job, then the window's
    assert len(calls) == jobs and len(chunks) == jobs * STREAM_CHUNKS
    assert chunks[:STREAM_CHUNKS] == [128, 128, 128, 128, 88]
    checks = r["checks"]
    for k in ("acq_mismatch", "sample_mismatch", "status_mismatch", "truth_mismatch"):
        assert checks[k]["value"] == 0
    assert checks["corr_rel"]["value"] < 1e-5


def _spy(monkeypatch):
    """Record each ``run_receiver`` call's arguments, then make it."""
    import softgnss_tpu_torch.pipeline as pipeline

    seen, orig = [], pipeline.run_receiver

    def spy(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)
    monkeypatch.setattr(pipeline, "run_receiver", spy)
    return seen


@pytest.mark.parametrize("name,extra", [("ref38.obs", {}), (STREAMED, {"stream": True})])
def test_a_mix_drives_run_receiver_with_its_own_keywords(monkeypatch, name, extra):
    """A mix without ``stream`` calls the program as the runner always has:
    the configuration, the capture where it was made, ``navigate`` and the
    device, nothing else; ``stream`` adds ``stream=True`` alone, and hands
    the capture over as a NumPy array in pageable host memory."""
    seen = _spy(monkeypatch)
    r = small_run(seconds=0.1, name=name).result
    assert r["correct"], r["checks"]
    assert len(seen) == 1 + r["attempted"]
    for a, k in seen:
        assert len(a) == 1 and type(a[0]).__name__ == "ReceiverConfig"
        assert set(k) == {"signal", "navigate", "device", *extra}
        assert k["navigate"] is False and k["device"] == torch.device("cpu")
        assert {x: k[x] for x in extra} == extra
        sig = k["signal"]
        if extra:
            assert type(sig) is np.ndarray and sig.dtype == np.int8
        else:
            assert isinstance(sig, torch.Tensor) and sig.device.type == "cpu"
            assert sig.dtype == torch.int8 and not sig.is_pinned()
    assert all(k["signal"] is seen[0][1]["signal"] for _, k in seen)


def test_where_a_mix_keeps_its_captures():
    c = torch.arange(-4, 4, dtype=torch.int8)
    for traffic in ({}, {"stream": False}):
        assert run.held(c, traffic) is c                 # kept where it was made
    for dtype in (torch.int8, torch.int16):               # the array takes the capture's type
        h = run.held(c.to(dtype), {"stream": True})
        assert type(h) is np.ndarray and h.dtype == c.to(dtype).numpy().dtype
        assert np.array_equal(h, c.numpy())
    with pytest.raises(ValueError, match="stream"):
        run.held(c, {"stream": "yes"})
    dev = torch.device("cpu")
    assert run.job_options({"navigate": False}, dev) == {"navigate": False, "device": dev}
    assert run.job_options({"navigate": False, "stream": False}, dev) == {"navigate": False,
                                                                           "device": dev}
    assert run.job_options({"navigate": True, "stream": True}, dev) == {
        "navigate": True, "device": dev, "stream": True}
    with pytest.raises(ValueError, match="stream"):
        run.job_options({"navigate": False, "stream": "yes"}, dev)


@pytest.mark.gpu
def test_a_streamed_capture_leaves_the_card():
    """A streamed mix's capture lies in the host's pageable memory, so the
    program uploads it through its pinned staging buffers, as it does a
    recording read from a file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from softgnss_tpu_torch.parallel import stream

    c = torch.arange(-64, 64, dtype=torch.int8, device="cuda")
    h = run.held(c, {"stream": True})
    assert type(h) is np.ndarray and np.array_equal(h, c.cpu().numpy())
    _, n, pinned, where = stream._source(h)
    assert (n, pinned, where.type) == (128, False, "cpu")
    assert run.held(c, {}) is c


def test_the_float32_control_fails():
    bench, cell, cfg, traffic = small_cell()
    got = control.readings(cell, cfg, traffic, SEED, control=True, device="cpu")["numbers"]
    assert not judge.passes(got, cfg["limits"]), got
    assert any(got[k] > cfg["limits"][k] for k in ("corr_rel", "carr_freq_hz", "code_freq_hz"))


def _broken(monkeypatch, fault):
    import softgnss_tpu_torch.pipeline as pipeline
    from softgnss_tpu_torch.config import ReceiverConfig
    from softgnss_tpu_torch.track import megakernel as mk

    if fault == "state_unchanged":
        orig = mk.track_block

        def block(frames, fb0, state, *a, **k):
            _, ys, ovf = orig(frames, fb0, state, *a, **k)
            return state, ys, ovf
        monkeypatch.setattr(mk, "track_block", block)
    elif fault == "half_the_channels":
        orig = pipeline.assign_channels

        def assign(config, acq):
            ch = orig(config, acq)
            half = len(ch) // 2
            ch.prn[half:] = 0
            ch.status[half:] = ["-"] * (len(ch) - half)
            return ch
        monkeypatch.setattr(pipeline, "assign_channels", assign)
    elif fault == "pll_update_wrong":
        # a PLL gain of the wrong sign: every loop loses lock and is demoted
        taus = ReceiverConfig.pll_taus.fget
        monkeypatch.setattr(ReceiverConfig, "pll_taus",
                            property(lambda self: (-taus(self)[0], taus(self)[1])))
    elif fault == "carrier_state_unchanged":
        # the carrier loop's state handed back as it came, the code loop's
        # and the pointers moved on: every chunk's window still holds them
        orig = mk.track_block
        carrier = ("carr_phase", "carr_freq", "carr_nco", "carr_err", "fll_ip", "fll_qp")

        def block(frames, fb0, state, *a, **k):
            new, ys, ovf = orig(frames, fb0, state, *a, **k)
            return new._replace(**{f: getattr(state, f) for f in carrier}), ys, ovf
        monkeypatch.setattr(mk, "track_block", block)
    elif fault == "answer_altered":
        for route in ("track", "track_streamed"):
            orig = getattr(pipeline, route)

            def track(*a, _orig=orig, **k):
                res = _orig(*a, **k)
                res.i_p[0, 100] *= 1.01
                return res
            monkeypatch.setattr(pipeline, route, track)


@pytest.mark.parametrize("name", ["ref38.obs", STREAMED])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_channels", "pll_update_wrong",
                                   "answer_altered", "carrier_state_unchanged"])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault, name):
    """The cells run on one card, so no exchange between chips can be left
    out; the streamed route meets each fault in every chunk.  A state left
    unchanged stops it first: its next chunk's window no longer holds the
    pointers, and the route raises, so the run ends with no result; a
    carrier state left unchanged keeps the pointers inside the windows and
    reaches the judge."""
    _broken(monkeypatch, fault)
    if (name, fault) == (STREAMED, "state_unchanged"):
        with pytest.raises(RuntimeError, match="chunk window violated"):
            small_run(seconds=0.1, name=name)
        return
    r = small_run(seconds=0.1, name=name).result
    assert not r["correct"], r["checks"]


def test_the_harness_loads_no_jax(tmp_path):
    code = ("import sys, json, torch\n"
            "torch.set_num_threads(2)\n"
            "from gnss_bench import control, run, registry\n"
            "from gnss_bench.test_bench_cells import small_run\n"
            "for m in registry.benchmark()['per_layer']: registry.metric(m['name'])\n"
            "r = small_run(seconds=0.1, trace=True)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "softgnss_tpu_torch" in loaded and "gnss_bench" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "softgnss_tpu_torchx.y", sys)
    assert "softgnss_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "softgnss_tpu.config", sys)
    assert "softgnss_tpu" in run.forbidden_modules()


def _command(cwd):
    return subprocess.run([sys.executable, "-m", "gnss_bench.run", "--workload", "ref38.obs",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gnss_bench", tmp_path / "gnss_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    code = ("from gnss_bench.test_bench_cells import small_run\n"
            "small_run(seconds=0.1)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0 and "softgnss_tpu_torch" in out.stderr


def test_every_seed_gives_the_same_sizes():
    from gnss_bench import generator

    _, _, cfg, traffic = small_cell()
    scenes = [generator.draw_scene(cfg["receiver"], traffic, s) for s in (1, SEED, 2**31 + 99)]
    assert len({(len(s.prn), s.n_samples) for s in scenes}) == 1
    assert all(len(set(s.prn.tolist())) == traffic["n_sats"] for s in scenes)
    a = generator.synthesize(scenes[1], "cpu", chunk=1 << 16)
    b = generator.synthesize(scenes[1], "cpu", chunk=1 << 20)
    assert torch.equal(a, b)
    s = scenes[1]
    want = np.sqrt(s.noise_std**2 + len(s.prn) * s.amplitude**2 / 2 + 1 / 12)
    assert np.isclose(float(a.float().std()), want, rtol=0.02)


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _command(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
