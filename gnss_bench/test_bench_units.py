"""CPU tests of the benchmark's parts that need no receiver run: the
registry, the statistics, the roofline reckoning, the trace reduction and
the C/A codes.  Run: python -m pytest gnss_bench -p no:cacheprovider"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from gnss_bench import codes, registry, roofline, stats, trace

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark(ROOT)


def test_registry_finds_every_part_by_name(bench):
    for cell in bench["workloads"]:
        cfg = registry.config(bench, cell["config"], ROOT)
        assert cfg["name"] == cell["config"]
        assert registry.traffic(cell["traffic"])["name"] == cell["traffic"]
    for m in bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert callable(mod.read)
    with pytest.raises(KeyError):
        registry.workload(bench, "no.such")
    with pytest.raises(KeyError):
        registry.metric("no_such_metric")


def test_every_cell_reports_what_the_contract_asks(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(bench, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(bench, cell["name"], "per_layer")
        assert cell["chips"] == 1


def test_configurations_hold_the_programs_defaults_but_the_front_end(bench):
    """``reduced`` is empty: in every configuration file, every receiver
    setting but the front end's sampling and intermediate frequency is
    default_config()'s."""
    from softgnss_tpu_torch.config import default_config

    base = default_config()
    assert all(entry["reduced"] == [] for entry in bench["configs"])
    for path in sorted((ROOT / "gnss_bench" / "configs").glob("*.json")):
        table = json.loads(path.read_text())["receiver"]
        for key, v in table.items():
            if key in ("sampling_freq", "intermediate_freq"):
                continue
            want = getattr(base, key)
            assert (tuple(v) if isinstance(v, list) else v) == want, key


@pytest.mark.parametrize("q,want", [(0, 1.0), (50, 3.0), (90, 7.6), (100, 10.0)])
def test_percentile_interpolates_between_order_statistics(q, want):
    xs = [4.0, 1.0, 10.0, 3.0, 2.0]
    assert stats.percentile(xs, q) == pytest.approx(want)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_rate_and_spread():
    assert stats.rate(37.0 * 100, 40.0) == pytest.approx(92.5)
    xs = [100.0, 102.0, 98.0, 101.0, 99.0, 130.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)
    assert stats.spread_trimmed(xs) < stats.spread(xs)
    assert stats.spread_trimmed(xs) == pytest.approx(stats.spread(xs[:5]))
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_roofline_counts_the_work_from_its_shapes():
    ops = roofline.track_ops(8, 37000, 38192)
    assert ops == 8 * 37000 * 38192 * 90
    assert roofline.track_bytes(37000, 38192) == 37000 * 38192
    assert roofline.track_bound_s(8, 37000, 38192) == pytest.approx(ops / 67e12)
    # one channel of a tiny front end is bandwidth-bound
    assert roofline.track_bound_s(0, 1000, 4096) == pytest.approx(1000 * 4096 / 3.35e12)


def _trace():
    tr = trace.Trace()
    tr.ranges[trace.JOB_RANGE] = [(0.0, 100.0), (100.0, 200.0)]
    tr.ranges["softgnss/acquire"] = [(0.0, 20.0), (100.0, 120.0)]
    tr.ranges["softgnss/track"] = [(20.0, 100.0), (120.0, 200.0)]
    tr.device = [(5.0, 15.0, "fft", True), (30.0, 50.0, "track_block_kernel", True),
                 (45.0, 60.0, "Memcpy DtoH", False), (130.0, 170.0, "track_block_kernel", True)]
    return tr


def test_trace_reduction_adds_up():
    tr = _trace()
    assert tr.window == (0.0, 200.0)
    assert trace.busy_us(tr) == pytest.approx(10 + 30 + 40)
    track = tr.ranges["softgnss/track"]
    assert trace.busy_us(tr, track) == pytest.approx(30 + 40)
    assert trace.busy_us(tr, track, kernels_only=True) == pytest.approx(20 + 40)
    assert trace.length(track) == pytest.approx(160.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["track_block_kernel", pytest.approx(60e-6)]
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx((200 - 80) / 1e6)
    track = [s for n, s in idle.items() if n.startswith("softgnss_track_")]
    # a gap counts where it starts: 60-130 and 170-200 start inside the track ranges
    assert track == [pytest.approx((70 + 30) / 1e6)]


def test_device_readers_on_a_known_trace():
    from gnss_bench.run import Readings

    r = Readings(timings=[{"acquire": 0.1, "track": 0.3}, {"acquire": 0.2, "track": 0.5}],
                 channels=2, n_ms=10, samples_per_code=4096, trace=_trace(), traced_jobs=2)
    got = {m: registry.metric(m).read(r) for m in
           ("acquire_s", "track_s", "idle_share", "track_idle_share", "track_roofline")}
    assert got["acquire_s"] == pytest.approx(0.15)
    assert got["track_s"] == pytest.approx(0.4)
    assert got["idle_share"] == pytest.approx(100 * (1 - 80 / 200))
    assert got["track_idle_share"] == pytest.approx(100 * (1 - 70 / 160))
    bound = 2 * roofline.track_bound_s(2, 10, 4096) * 1e6
    assert got["track_roofline"] == pytest.approx(100 * bound / 60.0)
    r.trace = None
    assert registry.metric("idle_share").read(r) is None
    assert registry.metric("track_roofline").read(r) is None


def test_gold_codes_are_the_published_ones():
    g = codes.gold_codes()
    assert g.shape == (32, 1023)
    # IS-GPS-200 Table 3-Ia: first 10 chips of PRN 1 and 2, octal 1440 and 1620
    first10 = lambda row: int("".join("1" if c > 0 else "0" for c in row[:10]), 2)  # noqa: E731
    assert first10(g[0]) == 0o1440 and first10(g[1]) == 0o1620
    # balanced codes: 512 ones, 511 zeros
    assert (g == 1).sum(1).tolist() == [512] * 32


@pytest.mark.parametrize("seed", range(8))
def test_the_reference_lock_rule_is_the_receivers(seed, bench):
    """reference.lock_lost against the program's channel_lock_loss on
    prompt series that hold lock, lose C/N0, or lose phase lock."""
    from softgnss_tpu_torch.config import default_config
    from softgnss_tpu_torch.profiling import channel_lock_loss
    from softgnss_tpu_torch.track.scan import TrackResults

    from gnss_bench import reference

    rng = np.random.default_rng(seed)
    c, n = 4, 3000
    bits = np.repeat(rng.choice([-1, 1], size=(c, n // 20 + 2)), 20, axis=1)
    bits = bits[:, rng.integers(0, 20):][:, :n]
    i_p = rng.uniform(0, 3, size=(c, 1)) * 50 * bits + rng.normal(0, 30, (c, n))
    q_p = rng.normal(0, 30 * rng.uniform(0.5, 3), (c, n))
    q_p[1, 1500:] += 200 * (seed % 2)
    z = np.zeros((c, n))
    tr = TrackResults(prn=np.arange(1, c + 1), status=["T"] * c, absolute_sample=z,
                      sample_frac=z, code_freq=z, carr_freq=z, i_p=i_p, i_e=z, i_l=z, q_e=z,
                      q_p=q_p, q_l=z, dll_discr=z, dll_discr_filt=z, pll_discr=z,
                      pll_discr_filt=z)
    table = json.loads((ROOT / bench["configs"][0]["file"]).read_text())["receiver"]
    want = np.isfinite(channel_lock_loss(default_config(), tr))
    got = reference.lock_lost(reference.Receiver.from_table(table), i_p, q_p)
    assert (got == want).all()
