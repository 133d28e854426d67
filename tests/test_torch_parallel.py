"""The port's distribution layer (softgnss_tpu_torch.parallel on
torch.distributed) against the JAX package's (softgnss_tpu.parallel) and
against the port's own one-device functions: the cases of
tests/test_sharding.py and the mesh cases of tests/test_stream.py.

The port's side runs in one gloo world of 4 ranks on the CPU, spawned once
for the module (``parallel.mesh.spawn_world``, one thread per rank, its own
timeout): every case runs inside it and each rank writes its results to
``.npz`` files.  The JAX side runs in this process on the 8 virtual CPU
devices of tests/conftest.py; JAX is imported only by the fixtures that use
it, so the spawned ranks, which import this module, load none of it.  The
inputs are the capture and channels of tests/test_sharding.py (NumPy, from
its seed).

Tolerances: channel sharding and exact time blocking bit-equal to the
port's ``track``; against JAX's channel sharding the port tracker's
standing ones (tests/test_tracking.py:165-176), the correlators against
the prompt amplitude (test_channel_sharded_vs_jax says why); time sharding within
tests/test_sharding.py's bounds of both the port's sequential run and
JAX's time-sharded run at the same number of shards; acquisition within
tests/test_sharding.py's (code phase equal, metric rtol 1e-5, carrier rtol
1e-9).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.acquire.search import Channels, acquire, assign_channels
from softgnss_tpu_torch.parallel import mesh as pmesh
from softgnss_tpu_torch.parallel.track import propagate_state, time_plan, time_span
from softgnss_tpu_torch.track.scan import MsOutputs, TrackState, track

torch.set_num_threads(1)

N_MS = 600
SKIP = 1001                       # a skip that is not a multiple of 4 samples
WORLD = 4
WORLD_TIMEOUT_S = 600.0
_OPTS = dict(number_of_channels=4, time_shard_warmup_ms=150)
_CORR = ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")


def _cfg(**kw):
    return sgt.fast_config(**{**_OPTS, **kw})


def _channels(d, key):
    return Channels(prn=d[f"{key}_prn"], acquired_freq=d[f"{key}_freq"],
                    code_phase=d[f"{key}_phase"], status=[str(s) for s in d[f"{key}_status"]])


# --------------------------------------------------------------------------
# the 4-rank world: every case, each rank's results to out_dir
# --------------------------------------------------------------------------

def _save(out_dir, name, res):
    rank = torch.distributed.get_rank()
    if hasattr(res, "peak_metric"):
        arrays = dict(carr_freq=res.carr_freq, code_phase=res.code_phase,
                      peak_metric=res.peak_metric)
    else:
        arrays = {f: getattr(res, f) for f in MsOutputs._fields}
        arrays.update({f"state_{f}": v.cpu().numpy()
                       for f, v in zip(TrackState._fields, res.final_state)})
        arrays["status"] = np.asarray(res.status)
    np.savez(os.path.join(out_dir, f"{name}.r{rank}.npz"), **arrays)


def _world(out_dir: str, data_path: str) -> None:
    from softgnss_tpu_torch.parallel import (
        acquire_sharded,
        make_mesh,
        receiver_mesh,
        track_channels_sharded,
        track_streamed,
        track_time_exact,
        track_time_sharded,
    )
    from softgnss_tpu_torch.pipeline import run_receiver

    rank = torch.distributed.get_rank()
    d = np.load(data_path)
    sig, ch4, ch_skip = d["signal"], _channels(d, "ch4"), _channels(d, "skip")
    cfg = _cfg()
    m14 = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 4})
    m22 = receiver_mesh(cfg, n_time=2)
    m41 = receiver_mesh(cfg, n_time=4, n_channel=1)
    save = lambda name, res: _save(out_dir, name, res)            # noqa: E731
    cpu = dict(device="cpu")

    save("acq", acquire_sharded(cfg, sig, m14, **cpu))
    save("acq_hinted", acquire_sharded(cfg, sig, m14, doppler_hints=d["hints"], **cpu))
    save("acq_uneven", acquire_sharded(cfg.with_options(acq_satellite_list=tuple(range(1, 23))),
                                       sig, m14, **cpu))

    save("channel", track_channels_sharded(cfg, sig, ch4, m14, n_ms=N_MS, **cpu))
    first = track_channels_sharded(cfg, sig, ch4, m14, n_ms=300, **cpu)
    save("channel_first", first)
    save("channel_resumed", track_channels_sharded(cfg, sig, ch4, m14, n_ms=N_MS - 300,
                                                   state=first.final_state, **cpu))
    ch3 = Channels(ch4.prn[:3], ch4.acquired_freq[:3], ch4.code_phase[:3], ch4.status[:3])
    save("channel_padded", track_channels_sharded(cfg, sig, ch3, m22, n_ms=200, **cpu))

    save("time_2", track_time_sharded(cfg, sig, ch4, m22, n_ms=N_MS, **cpu))
    save("time_4", track_time_sharded(cfg.with_options(time_shard_warmup_ms=100), sig, ch4,
                                      m41, n_ms=N_MS, **cpu))
    save("time_skip", track_time_sharded(cfg.with_options(skip_samples=SKIP), sig, ch_skip,
                                         m22, n_ms=N_MS, **cpu))
    save("exact", track_time_exact(cfg, sig, ch4, m41, n_ms=N_MS, **cpu))

    ckpt = os.path.join(out_dir, "mesh_ckpt.npz")
    for shard in ("channel", "time", "time-exact"):
        res = run_receiver(cfg, signal=sig, n_ms=300, navigate=False, mesh=m22, shard=shard,
                           checkpoint=ckpt if shard == "channel" else None, **cpu)
        save(f"rr_{shard}", res.tracking)
        if shard == "channel":
            save("rr_acq", res.acquisition)
    save("rr_loaded", run_receiver(cfg, signal=sig, n_ms=300, navigate=False, mesh=m22,
                                   checkpoint=ckpt, **cpu).tracking)

    save("stream", track_streamed(cfg, sig, ch4, n_ms=N_MS, chunk_ms=128, mesh=m14, **cpu))
    save("rr_stream", run_receiver(cfg, signal=sig, n_ms=N_MS, navigate=False, mesh=m14,
                                   shard="channel", stream=True, **cpu).tracking)

    # every refusal raises on every rank, and the world goes on
    refused = {}

    def refuse(name, fn):
        try:
            fn()
        except (ValueError, RuntimeError) as exc:
            refused[name] = [type(exc).__name__, str(exc)]

    refuse("time_indivisible", lambda: track_time_sharded(cfg, sig, ch4, m22, n_ms=333, **cpu))
    refuse("exact_indivisible", lambda: track_time_exact(cfg, sig, ch4, m41, n_ms=333, **cpu))
    refuse("block_too_short", lambda: track_time_sharded(cfg, sig, ch4, m41, n_ms=8, **cpu))
    refuse("stream_time", lambda: run_receiver(cfg, signal=sig, n_ms=N_MS, navigate=False,
                                               mesh=m22, shard="time", stream=True, **cpu))
    refuse("bogus_shard", lambda: run_receiver(cfg, signal=sig, n_ms=N_MS, navigate=False,
                                               mesh=m22, shard="bogus", **cpu))
    refuse("mesh_size", lambda: make_mesh({cfg.time_axis: 2, cfg.channel_axis: 4}))

    def one_rank_fails():
        if rank == 1:
            raise ValueError("rank 1's own failure")
        return None, 0

    refuse("one_rank_fails", lambda: pmesh.run_together(one_rank_fails))
    with open(os.path.join(out_dir, f"refused.r{rank}.json"), "w") as f:
        json.dump(refused, f)


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jcfg():
    import softgnss_tpu as sg

    return sg.fast_config(**_OPTS)


@pytest.fixture(scope="module")
def capture(jcfg):
    """tests/test_sharding.py's capture (JAX synthesizer, NumPy), its
    satellites and the port's channels from it, at skip 0 and at SKIP."""
    from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal

    nav_bits = tuple(np.random.default_rng(1).choice([-1, 1], size=64))
    sats = [SatelliteSignal(prn=4, doppler_hz=1800.0, delay_samples=700.0, phase0=0.5,
                            nav_bits=nav_bits),
            SatelliteSignal(prn=11, doppler_hz=-1200.0, delay_samples=2222.0, phase0=1.5,
                            nav_bits=nav_bits),
            SatelliteSignal(prn=19, doppler_hz=3100.0, delay_samples=3555.0, phase0=2.5,
                            nav_bits=nav_bits)]
    signal = np.array(synthesize_signal(jcfg, sats, N_MS + 13, noise_std=1.0, seed=8))
    cfg = _cfg()
    ch4 = assign_channels(cfg, acquire(cfg, torch.from_numpy(signal)))
    cfg_skip = cfg.with_options(skip_samples=SKIP)
    need = cfg.acquisition_ms * cfg.samples_per_code
    ch_skip = assign_channels(cfg_skip, acquire(cfg_skip, torch.from_numpy(
        signal[SKIP:SKIP + need].copy())))
    return sats, signal, ch4, ch_skip


@pytest.fixture(scope="module")
def world(tmp_path_factory, capture):
    """The directory the 4-rank world wrote every case's results into."""
    sats, signal, ch4, ch_skip = capture
    out = tmp_path_factory.mktemp("torch_world")
    hints = np.full(32, np.nan)
    for s in sats:
        hints[s.prn - 1] = _cfg().intermediate_freq + s.doppler_hz + 90.0
    data = str(out / "data.npz")
    np.savez(data, signal=signal, hints=hints,
             **{f"{k}_{f}": np.asarray(v) for k, ch in (("ch4", ch4), ("skip", ch_skip))
                for f, v in (("prn", ch.prn), ("freq", ch.acquired_freq),
                             ("phase", ch.code_phase), ("status", ch.status))})
    pmesh.spawn_world(_world, WORLD, (str(out), data), device="cpu", timeout=WORLD_TIMEOUT_S)
    return out


def _load(world, name, rank=0):
    return dict(np.load(world / f"{name}.r{rank}.npz"))


def _as_results(d):
    """A saved TrackResults' arrays as attributes, its state as a TrackState."""
    state = TrackState(*[torch.from_numpy(d[f"state_{f}"]) for f in TrackState._fields])
    return SimpleNamespace(**{**d, "status": [str(s) for s in d["status"]]}, final_state=state)


@pytest.fixture(scope="module")
def port_ref(capture):
    """The port's one-device tracking of the capture (CPU)."""
    _, signal, ch4, _ = capture
    return track(_cfg(), torch.from_numpy(signal), ch4, n_ms=N_MS)


def _jax_channels(ch):
    from softgnss_tpu.acquire.search import Channels as JChannels

    return JChannels(prn=ch.prn.copy(), acquired_freq=ch.acquired_freq.copy(),
                     code_phase=ch.code_phase.copy(), status=list(ch.status))


def _jmesh(jcfg, n_t, n_c):
    from softgnss_tpu.parallel import make_mesh

    return make_mesh({jcfg.time_axis: n_t, jcfg.channel_axis: n_c})


# --------------------------------------------------------------------------
# the world's results
# --------------------------------------------------------------------------

_CASES = ("acq", "acq_hinted", "acq_uneven", "channel", "channel_first", "channel_resumed",
          "channel_padded", "time_2", "time_4", "time_skip", "exact", "rr_channel", "rr_time",
          "rr_time-exact", "rr_acq", "rr_loaded", "stream", "rr_stream")


@pytest.mark.parametrize("case", _CASES)
def test_every_rank_gets_the_whole_result(world, case):
    ref = _load(world, case)
    for rank in range(1, WORLD):
        got = _load(world, case, rank)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"rank {rank}: {k}")


@pytest.mark.parametrize("case, opts, hinted", [
    ("acq", {}, False), ("acq_hinted", {}, True),
    ("acq_uneven", {"acq_satellite_list": tuple(range(1, 23))}, False)],
    ids=["plain", "hinted", "uneven_prn_padding"])
def test_acquisition_matches_jax_and_port(world, capture, jcfg, case, opts, hinted):
    """PRN-sharded acquisition on a 1x4 mesh: equal to the port's unsharded
    acquire and within tests/test_sharding.py's tolerances of JAX's
    acquire_sharded on a 1x8 mesh."""
    from softgnss_tpu.parallel import acquire_sharded as jacquire_sharded

    sats, signal, _, _ = capture
    got = _load(world, case)
    hints = None
    if hinted:
        hints = np.full(32, np.nan)
        for s in sats:
            hints[s.prn - 1] = jcfg.intermediate_freq + s.doppler_hz + 90.0
    ref = acquire(_cfg(**opts), torch.from_numpy(signal), doppler_hints=hints)
    for k in ("carr_freq", "code_phase", "peak_metric"):
        np.testing.assert_array_equal(got[k], getattr(ref, k), err_msg=k)
    j = jacquire_sharded(jcfg.with_options(**opts), signal, _jmesh(jcfg, 1, 8),
                         doppler_hints=hints)
    np.testing.assert_array_equal(got["code_phase"], j.code_phase)
    np.testing.assert_allclose(got["peak_metric"], j.peak_metric, rtol=1e-5)
    np.testing.assert_allclose(got["carr_freq"], j.carr_freq, rtol=1e-9)


def _assert_bit_equal(got, ref):
    for f in MsOutputs._fields:
        np.testing.assert_array_equal(got[f], getattr(ref, f), err_msg=f)
    for f, v in zip(TrackState._fields, ref.final_state):
        np.testing.assert_array_equal(got[f"state_{f}"], v.cpu().numpy(), err_msg=f)
    assert [str(s) for s in got["status"]] == list(ref.status)


def test_channel_sharded_bit_equal_to_port(world, capture, port_ref):
    """1x4 mesh: every output and the final state bit-equal to ``track``;
    a run resumed from a sharded run's final state too."""
    _, signal, ch4, _ = capture
    _assert_bit_equal(_load(world, "channel"), port_ref)
    first = track(_cfg(), torch.from_numpy(signal), ch4, n_ms=300)
    _assert_bit_equal(_load(world, "channel_first"), first)
    second = track(_cfg(), torch.from_numpy(signal), ch4, n_ms=N_MS - 300,
                   state=first.final_state)
    _assert_bit_equal(_load(world, "channel_resumed"), second)
    joined = np.concatenate([_load(world, "channel_first")["i_p"],
                             _load(world, "channel_resumed")["i_p"]], axis=1)
    np.testing.assert_array_equal(joined, port_ref.i_p)


def test_channel_padding(world, capture):
    """3 channels over a channel dimension of 2 (2x2 mesh): one idle pad row,
    dropped; bit-equal to ``track`` of the 3 channels."""
    _, signal, ch4, _ = capture
    ch3 = Channels(ch4.prn[:3], ch4.acquired_freq[:3], ch4.code_phase[:3], ch4.status[:3])
    got = _load(world, "channel_padded")
    assert got["i_p"].shape == (3, 200)
    _assert_bit_equal(got, track(_cfg(), torch.from_numpy(signal), ch3, n_ms=200))


def test_channel_sharded_vs_jax(world, capture, jcfg):
    """Against JAX track_channels_sharded ('gather', 1x4): absolute_sample
    within +-1, carr_freq as tests/test_tracking.py:176 holds it, and every
    correlator within 1e-4 of the prompt amplitude (the RMS of
    |I_P + j Q_P|).  The per-arm form of tests/test_tracking.py:173-175
    (1e-4 of each arm's own RMS) reads 1.17e-4 on q_p here, the same for the
    unsharded port tracker against JAX's unsharded 'gather': q_p's own RMS
    is a seventh of the prompt amplitude on a locked channel, and the gap is
    JAX's float32 sums against the port's once-rounded float64 ones, which
    sharding does not touch (the port's sharded run is bit-equal to its
    unsharded one, test_channel_sharded_bit_equal_to_port)."""
    from softgnss_tpu.parallel import track_channels_sharded as jtrack_channels_sharded

    _, signal, ch4, _ = capture
    got = _load(world, "channel")
    ref = jtrack_channels_sharded(jcfg.with_options(correlator_impl="gather"), signal,
                                  _jax_channels(ch4), _jmesh(jcfg, 1, 4), n_ms=N_MS)
    assert np.max(np.abs(got["absolute_sample"] - ref.absolute_sample)) <= 1
    amplitude = np.sqrt(np.mean(np.asarray(ref.i_p) ** 2 + np.asarray(ref.q_p) ** 2))
    for key in _CORR:
        assert np.max(np.abs(got[key] - getattr(ref, key))) / amplitude < 1e-4, key
    np.testing.assert_allclose(got["carr_freq"], ref.carr_freq, atol=1e-6)


@pytest.mark.parametrize("start_ms", [0, 250, 400])
def test_propagate_state_matches_jax(capture, jcfg, start_ms):
    from softgnss_tpu.parallel.track import propagate_state as jpropagate

    _, _, ch4, _ = capture
    got = propagate_state(_cfg(), ch4, start_ms)
    ref = jpropagate(jcfg, _jax_channels(ch4), start_ms)
    for f, v in zip(TrackState._fields, got):
        want = np.asarray(getattr(ref, f))
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=f)


def _assert_time_bounds(sh, ref, active, agree_min):
    """tests/test_sharding.py's bounds of a time-sharded run against a
    sequential (or another time-sharded) one."""
    for c in active:
        assert np.max(np.abs(sh.absolute_sample[c] - ref.absolute_sample[c])) <= 1
        agree = np.mean(np.sign(sh.i_p[c, 50:]) == np.sign(ref.i_p[c, 50:]))
        assert agree > agree_min, f"channel {c}: sign agreement {agree}"
        assert np.median(np.abs(sh.carr_freq[c, 50:] - ref.carr_freq[c, 50:])) < 2.0
        assert np.abs(sh.i_p[c, 50:]).mean() > 0.9 * np.abs(ref.i_p[c, 50:]).mean()


@pytest.mark.parametrize("case, n_t, warmup, skip, agree_min", [
    ("time_2", 2, 150, 0, 0.99), ("time_4", 4, 100, 0, 0.985),
    ("time_skip", 2, 150, SKIP, 0.99)],
    ids=["2_shards", "4_shards", "skip_not_word_aligned"])
def test_time_sharded(world, capture, jcfg, case, n_t, warmup, skip, agree_min):
    """Against the port's sequential ``track`` and JAX track_time_sharded at
    the same number of time shards."""
    from softgnss_tpu.parallel import track_time_sharded as jtrack_time_sharded

    _, signal, ch4, ch_skip = capture
    chans = ch_skip if skip else ch4
    cfg = _cfg(time_shard_warmup_ms=warmup, skip_samples=skip)
    sh = _as_results(_load(world, case))
    assert sh.i_p.shape == (4, N_MS)
    active = [c for c in range(len(chans)) if chans.status[c] == "T"]
    assert len(active) == 3
    seq = track(cfg, torch.from_numpy(signal), chans, n_ms=N_MS)
    _assert_time_bounds(sh, seq, active, agree_min)
    assert np.max(np.abs(sh.final_state.ptr.numpy()[active]
                         - seq.final_state.ptr.numpy()[active])) <= 1
    jc = jcfg.with_options(time_shard_warmup_ms=warmup, skip_samples=skip,
                           correlator_impl="gather")
    jsh = jtrack_time_sharded(jc, signal, _jax_channels(chans), _jmesh(jcfg, n_t, 8 // n_t),
                              n_ms=N_MS)
    _assert_time_bounds(sh, jsh, active, agree_min)
    # the JAX package's final block_base stays relative to the last shard's
    # span; the port's is in capture coordinates, like its pointer
    base, lo, _ = time_span(cfg, signal, n_t - 1, n_t, N_MS // n_t, min(warmup, N_MS // n_t - 2))
    d = sh.final_state.block_base.numpy()[active] - base
    assert np.max(np.abs(d - np.asarray(jsh.final_state.block_base)[active])) <= 1


def _jax_assembled(jcfg, signal, n_t, n_ms, warmup):
    """The spans softgnss_tpu/parallel/track.py:226-238 assembles on each
    time shard: its own block and the overlap-save halos lax.ppermute hands
    it over the time ring, the last shard's next halo from the zero-padded
    tail (the same statements, run on the 8 virtual devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    t_axis = jcfg.time_axis
    spc, skip = jcfg.samples_per_code, jcfg.skip_samples
    halo_prev, halo_next = (warmup + 1) * spc, (warmup + 2) * spc
    body = np.ascontiguousarray(signal[skip: skip + n_ms * spc])
    tail = np.zeros((warmup + 2) * spc, body.dtype)
    tail[:2 * spc] = signal[skip + n_ms * spc: skip + (n_ms + 2) * spc]

    def shard_fn(sig_l, tail_r):
        b = jax.lax.axis_index(t_axis)
        prev_tail = jax.lax.ppermute(sig_l[-halo_prev:], t_axis,
                                     [(i, (i + 1) % n_t) for i in range(n_t)])
        next_head = jax.lax.ppermute(sig_l[:halo_next], t_axis,
                                     [(i, (i - 1) % n_t) for i in range(n_t)])
        next_head = jnp.where(b == n_t - 1, tail_r, next_head)
        return jnp.concatenate([prev_tail, sig_l, next_head])[None]

    out = jax.shard_map(shard_fn, mesh=_jmesh(jcfg, n_t, 1), in_specs=(P(t_axis), P()),
                        out_specs=P(t_axis))(jnp.asarray(body), jnp.asarray(tail))
    return np.asarray(out)


@pytest.mark.parametrize("n_t, warmup, skip", [(2, 150, 0), (4, 100, 0), (2, 150, SKIP)],
                         ids=["2_shards", "4_shards", "skip_not_word_aligned"])
def test_time_spans_equal_jax_halos(capture, jcfg, n_t, warmup, skip):
    """Each time shard's span (what each rank uploads) holds the bytes JAX's
    ppermute assembles, from a word-aligned first sample; shard 0's previous
    halo holds the capture before ``skip`` (JAX's wraps around the ring)."""
    _, signal, _, _ = capture
    cfg = _cfg(time_shard_warmup_ms=warmup, skip_samples=skip)
    block_ms, w = time_plan(cfg, N_MS, n_t, signal.shape[0])
    assert w == warmup
    jspans = _jax_assembled(jcfg.with_options(skip_samples=skip), signal, n_t, N_MS, w)
    halo_prev = (w + 1) * cfg.samples_per_code
    for b in range(n_t):
        base, lo, span = time_span(cfg, signal, b, n_t, block_ms, w)
        assert lo % 4 == 0 and 0 <= base - lo < 4
        span = span.numpy()[base - lo:]
        keep = slice(halo_prev if b == 0 else 0, None)
        np.testing.assert_array_equal(span[keep], jspans[b][keep], err_msg=f"shard {b}")
        if b == 0:
            want = np.zeros(halo_prev, np.int8)
            have = signal[max(base, 0):base + halo_prev]
            want[halo_prev - len(have):] = have
            np.testing.assert_array_equal(span[:halo_prev], want)


def test_time_exact_bit_equal_to_port(world, port_ref):
    """4x1 mesh, four 150-ms blocks carrying the state (each resumes
    mid-block): every output and the final state bit-equal to ``track``.
    (The JAX package holds its float64 streams to rtol 1e-5 / atol 0.01 of
    its one-device run, tests/test_sharding.py:166-189; the port's are
    bit-equal, as are its integer observables and i_p signs.)"""
    _assert_bit_equal(_load(world, "exact"), port_ref)


def test_refusals_raise_on_every_rank(world):
    """Indivisible n_ms, a block too short, stream with time sharding, a
    bogus shard and a mesh the world cannot hold raise the same error on
    every rank; one rank's failure inside run_together raises on all."""
    want = {"time_indivisible": ("ValueError", "divisible"),
            "exact_indivisible": ("ValueError", "divisible"),
            "block_too_short": ("ValueError", "cannot host a warm-up"),
            "stream_time": ("ValueError", "shard='channel'"),
            "bogus_shard": ("ValueError", "shard must be"),
            "mesh_size": ("ValueError", "world size is 4")}
    for rank in range(WORLD):
        with open(world / f"refused.r{rank}.json") as f:
            got = json.load(f)
        for name, (kind, text) in want.items():
            assert got[name][0] == kind and text in got[name][1], (rank, name, got[name])
        if rank == 1:
            assert got["one_rank_fails"] == ["ValueError", "rank 1's own failure"]
        else:
            assert got["one_rank_fails"] == ["RuntimeError",
                                              "rank 1 failed; its error is in its own output"]


def test_run_receiver_on_mesh(world, capture):
    """run_receiver(mesh=2x2): acquisition and channel-sharded tracking equal
    to the unsharded run, time-exact too, time sharding the same shape; the
    checkpoint rank 0 wrote is loaded by every rank."""
    _, signal, _, _ = capture
    base = sgt.run_receiver(_cfg(), signal=signal, n_ms=300, navigate=False, device="cpu")
    for case in ("rr_channel", "rr_time-exact", "rr_loaded"):
        _assert_bit_equal(_load(world, case), base.tracking)
    np.testing.assert_array_equal(_load(world, "rr_acq")["code_phase"],
                                  base.acquisition.code_phase)
    assert _load(world, "rr_time")["i_p"].shape == base.tracking.i_p.shape
    assert (world / "mesh_ckpt.npz").exists()


def test_streamed_on_mesh(world, port_ref):
    """track_streamed(mesh=1x4) in 128-ms chunks and run_receiver(stream=True,
    mesh=1x4): every output bit-equal to the monolithic tracker's."""
    _assert_bit_equal(_load(world, "stream"), port_ref)
    _assert_bit_equal(_load(world, "rr_stream"), port_ref)


def test_world_timeout_fails_instead_of_hanging():
    """A world that does not end within its timeout is killed and raises."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not end"):
        pmesh.spawn_world(time.sleep, 1, (120,), device="cpu", timeout=5)
    assert time.monotonic() - t0 < 60


def test_dryrun_multichip_on_the_cpu(capfd):
    """The port's counterpart of __graft_entry__.dryrun_multichip in a world
    of 2 ranks: sharded calls, run_receiver under channel and time sharding,
    and the 12-s warm-start fix under both (median 3D error < 40 m)."""
    from softgnss_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu", timeout=WORLD_TIMEOUT_S)
    assert "dryrun_multichip OK" in capfd.readouterr().out
