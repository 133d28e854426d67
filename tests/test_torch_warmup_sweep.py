"""softgnss_tpu_torch.scripts.warmup_sweep on the CPU against the JAX
package.

The JAX script runs at import, so this test calls what it wraps: the
capture is the JAX scenario synthesizer's (scripts/warmup_sweep.py's
geometry, cut to 1 200 ms), the truth the port's sequential
``run_receiver``; the port's sweep runs in one gloo world of 2 x 1 ranks
at warm-ups 25 and 100 ms, and JAX ``track_time_sharded`` at the same
warm-ups on 2 time shards of the 8 virtual CPU devices.  Tolerances:
those of tests/test_torch_parallel.py::test_time_sharded (and
tests/test_sharding.py): absolute_sample within 1, nav-bit signs agreeing
> 0.99 past 50 ms, median |carr_freq| difference < 2 Hz, prompt power
within 10 %.  The row figures are held to the JAX script's formula
(copied here) on JAX's own arrays.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.scripts import warmup_sweep as ws

torch.set_num_threads(1)

N_MS = 1200
WARMUPS = (25, 100)
N_TIME = 2


def _jax_row(seq, tr, warmup, n_ms):
    """scripts/warmup_sweep.py:34-38, copied (its 4 shards: 3 * warmup)."""
    sl = np.s_[:, 500:]
    bit_err = np.mean(np.sign(tr.i_p[sl]) != np.sign(seq.i_p[sl]))
    das = np.abs(tr.absolute_sample[sl] - seq.absolute_sample[sl])
    df = np.abs(tr.carr_freq[sl] - seq.carr_freq[sl])
    overhead = 100.0 * 3 * warmup / n_ms
    return 100 * bit_err, das.max(), np.median(das), df.max(), overhead


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX capture, the port's sequential run, the port's sweep (rows,
    launches, the stitched outputs it kept) and JAX's time-sharded runs."""
    import softgnss_tpu as sg
    from softgnss_tpu.acquire.search import Channels as JChannels
    from softgnss_tpu.parallel import make_mesh
    from softgnss_tpu.parallel import track_time_sharded as jtrack_time_sharded
    from softgnss_tpu.scenario import build_scenario, synthesize_scenario
    from softgnss_tpu.track import track as jtrack

    jcfg = sg.fast_config(number_of_channels=5, ms_to_process=N_MS, acq_noncoherent_ms=10,
                          correlator_impl="gather")
    sc = build_scenario(jcfg, n_sats=5)
    signal = np.asarray(synthesize_scenario(sc, N_MS + jcfg.acquisition_ms + 2))
    cfg = ws.sweep_config(ms_to_process=N_MS)
    base = run_receiver(cfg, signal=torch.from_numpy(signal.copy()), n_ms=N_MS,
                        navigate=False, device="cpu")
    out = tmp_path_factory.mktemp("warmup")
    rows, launches = ws.sweep(cfg, signal, base.channels, base.tracking, n_ms=N_MS,
                              n_time=N_TIME, n_channel=1, warmups=WARMUPS, device="cpu",
                              out_dir=str(out))
    ch = base.channels
    jch = JChannels(prn=ch.prn.copy(), acquired_freq=ch.acquired_freq.copy(),
                    code_phase=ch.code_phase.copy(), status=list(ch.status))
    mesh = make_mesh({jcfg.time_axis: N_TIME, jcfg.channel_axis: 8 // N_TIME})
    jsh = {w: jtrack_time_sharded(jcfg.with_options(time_shard_warmup_ms=w), signal, jch, mesh,
                                  n_ms=N_MS) for w in WARMUPS}
    jseq = jtrack(jcfg, signal, jch, n_ms=N_MS)
    kept = {w: SimpleNamespace(**np.load(out / f"time_{w}.npz")) for w in WARMUPS}
    return base, rows, launches, kept, jsh, jseq


def _assert_time_bounds(sh, ref, active):
    """tests/test_torch_parallel.py's bounds of a time-sharded run against
    another run of the same capture."""
    for c in active:
        assert np.max(np.abs(sh.absolute_sample[c] - ref.absolute_sample[c])) <= 1
        agree = np.mean(np.sign(sh.i_p[c, 50:]) == np.sign(ref.i_p[c, 50:]))
        assert agree > 0.99, f"channel {c}: sign agreement {agree}"
        assert np.median(np.abs(sh.carr_freq[c, 50:] - ref.carr_freq[c, 50:])) < 2.0
        assert np.abs(sh.i_p[c, 50:]).mean() > 0.9 * np.abs(ref.i_p[c, 50:]).mean()


@pytest.mark.parametrize("warmup", WARMUPS)
def test_stitched_tracking_matches_jax_time_sharded(case, warmup):
    base, _, _, kept, jsh, _ = case
    active = [c for c, s in enumerate(base.channels.status) if s == "T"]
    assert len(active) == 5
    got = kept[warmup]
    assert got.i_p.shape == (5, N_MS)
    _assert_time_bounds(got, jsh[warmup], active)
    _assert_time_bounds(got, base.tracking, active)


def test_rows_are_the_figures_of_the_kept_outputs(case):
    """Rank 0's rows, in warm-up order, are warmup_row of what it kept
    against the sequential run; every rank tracked (plain versions: no
    kernel launch on the CPU)."""
    base, rows, launches, kept, _, _ = case
    assert [r["warmup"] for r in rows] == list(WARMUPS)
    for row in rows:
        want = ws.warmup_row(base.tracking, kept[row["warmup"]], row["warmup"], N_MS, N_TIME)
        assert {k: row[k] for k in want} == want
        assert row["track_s"] > 0
        assert row["max_das"] <= 1 and row["bit_err_pct"] < 1.0
    assert len(launches) == N_TIME and all(set(v.values()) == {0} for v in launches)


@pytest.mark.parametrize("warmup", WARMUPS)
def test_warmup_row_is_the_jax_formula(case, warmup):
    """On JAX's own sequential and time-sharded arrays, at the JAX script's
    4 shards (3 * warmup overhead) and at these 2."""
    _, _, _, _, jsh, jseq = case
    seq = SimpleNamespace(**{f: np.asarray(getattr(jseq, f))
                             for f in ("i_p", "absolute_sample", "carr_freq")})
    tr = SimpleNamespace(**{f: np.asarray(getattr(jsh[warmup], f))
                            for f in ("i_p", "absolute_sample", "carr_freq")})
    row = ws.warmup_row(seq, tr, warmup, N_MS, 4)
    want = _jax_row(seq, tr, warmup, N_MS)
    got = (row["bit_err_pct"], row["max_das"], row["med_das"], row["max_df_hz"],
           row["overhead_pct"])
    assert got == pytest.approx(want, rel=0, abs=0)
    assert ws.warmup_row(seq, tr, warmup, N_MS, N_TIME)["overhead_pct"] == \
        100.0 * warmup / N_MS


def test_sweep_geometry_is_the_jax_scripts():
    cfg = ws.sweep_config()
    assert (cfg.number_of_channels, cfg.ms_to_process, cfg.acq_noncoherent_ms) == (5, 12000, 10)
    assert cfg.sampling_freq == 4_096_000.0
    assert ws.WARMUPS == (25, 50, 100, 150, 250, 400, 700, 1000)
    assert (ws.N_TIME, ws.N_CHANNEL, ws.SKIP_MS) == (4, 2, 500)
