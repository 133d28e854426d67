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
SMALL = {"sampling_freq": 4_096_000.0, "intermediate_freq": 1_000_000.0, "ms_to_process": 600}


def small_cell(name="ref38.obs", captures=1):
    """The cell at the small front end; ``captures`` distinct captures (a
    job takes seconds on the CPU, so most tests cycle through one)."""
    bench = registry.benchmark(ROOT)
    cell = registry.workload(bench, name)
    cfg = copy.deepcopy(registry.config(bench, cell["config"], ROOT))
    cfg["receiver"].update(SMALL)
    traffic = dict(registry.traffic(cell["traffic"]), captures=captures)
    return bench, cell, cfg, traffic


def small_run(seconds=0.5, trace=False, seed=SEED, captures=1):
    bench, cell, cfg, traffic = small_cell(captures=captures)
    try:
        return run.run_cell(bench, cell, cfg, traffic, seed, seconds, trace, device="cpu")
    finally:
        gc.unfreeze()                        # run_cell freezes what set-up made


def test_sound_run_is_correct_and_reports_its_metrics():
    run_ = small_run(seconds=5.0, captures=3)
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


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    r = small_run(trace=True).result
    assert r["correct"]
    # no card here: the device-trace readers find nothing and are left out
    assert set(r["metrics"]) == {"acquire_s", "track_s"}
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0


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
    elif fault == "answer_altered":
        orig = pipeline.track

        def track(*a, **k):
            res = orig(*a, **k)
            res.i_p[0, 100] *= 1.01
            return res
        monkeypatch.setattr(pipeline, "track", track)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_channels", "pll_update_wrong",
                                   "answer_altered"])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault):
    """The cell runs on one card, so no exchange between chips can be left out."""
    _broken(monkeypatch, fault)
    r = small_run(seconds=0.1).result
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
