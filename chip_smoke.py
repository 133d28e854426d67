#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (softgnss_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its seconds; the first failure raises and the
script exits non-zero:

1. card      — device name and nvidia-smi's name / power limit
2. build     — nvcc builds both kernels from softgnss_tpu_torch/csrc
3. nco       — signals.nco on CUDA tensors bit-equal to the same on CPU
4. B2        — build_frames kernel bit-equal to its plain version at the
               default geometry, frames past the capture ends included
5. B1        — track_block kernel vs its plain version over 256 ms of an
               8-satellite default_config capture synthesized on the card,
               with a resume (lead segment), at default and in a variant
               config (pdi_ms=4, FLL, carrier-aided DLL, spacing 0.25)
6. main path — run_receiver(default_config(), navigate=False,
               device="cuda") over the reference's 37 000 ms: every
               injected PRN acquired and locked, every block through both
               kernels

The line before the last is nvidia-smi's card name and power limit, the
one before it the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
N_SATS = 8
NOISE_STD = 8.0
#: C/N0 range, dB-Hz: at acq_noncoherent_ms=2 a 50-51 dB-Hz satellite's
#: peak metric sits near the 2.5 threshold (~2.3-3.9 on the fast front
#: end), so the upper part of the 50-54 dB-Hz band keeps acquisition sure
CN0_DBHZ = (52.0, 54.0)
#: capture ms: the reference's ms_to_process plus acquisition and slack
CAPTURE_MS = 37_020
MAIN_MS = 37_000
PARITY_MS = (100, 156)     # two track calls: the second resumes mid-block
TOL_CORR = 1e-4            # max |kernel - plain| / RMS, each correlator
TOL_FREQ_HZ = 1e-3         # carr/code freq, a tenth of the NCO step fs/2^32
TOL_FRAC = 1e-6            # sample_frac


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.3f} s)", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean device ms of ``fn()`` over ``n`` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def make_scenario(cfg):
    from softgnss_tpu_torch.signals.synth import SatelliteSignal, amplitude_for_cn0

    rng = np.random.default_rng(SEED)
    prns = rng.choice(np.arange(1, 33), N_SATS, replace=False)
    sats = []
    for prn in prns:
        sats.append(SatelliteSignal(
            prn=int(prn), doppler_hz=float(rng.uniform(-5000, 5000)),
            # whole-sample delays: the acquisition grid has one-sample lags
            delay_samples=float(rng.integers(0, cfg.samples_per_code)),
            amplitude=amplitude_for_cn0(cfg, float(rng.uniform(*CN0_DBHZ)), NOISE_STD),
            phase0=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=tuple(int(b) for b in rng.choice([-1, 1], 64))))
    return sats


def phase_nco(dev) -> None:
    import torch

    from softgnss_tpu_torch.signals import nco

    rng = np.random.default_rng(SEED)
    p0 = torch.from_numpy(rng.integers(-2**31, 2**31, 100_000).astype(np.int32))
    w = torch.from_numpy(rng.integers(-2**31, 2**31, 100_000).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 400_000, 100_000).astype(np.int32))
    f = torch.from_numpy(np.concatenate([rng.uniform(-2e7, 2e7, 10_000), [0.0, -1.0]]))
    q = torch.from_numpy(rng.integers(-2**52, 2**52, 10_000))
    x = torch.from_numpy(rng.uniform(-3, 3, 100_000).astype(np.float32))
    cases = {
        "carrier_turns": lambda d: nco.carrier_turns(p0.to(d), w.to(d), k.to(d)),
        "carrier_sin_cos": lambda d: torch.stack(nco.carrier_sin_cos(p0.to(d), w.to(d), k.to(d))),
        "sin_turns": lambda d: nco.sin_turns(x.to(d)),
        "carrier_step_u32": lambda d: nco.carrier_step_u32(f.to(d), 38_192_000.0),
        "code_step_q": lambda d: nco.code_step_q(f.abs().to(d), 38_192_000.0),
        "ceil_chip_index": lambda d: nco.ceil_chip_index(q.to(d)),
    }
    for name, fn in cases.items():
        check(torch.equal(fn(dev).cpu(), fn("cpu")), f"nco.{name}: CUDA != CPU")
    print(f"  {len(cases)} NCO functions bit-equal on CUDA and CPU")


def phase_b2(cfg, dev) -> dict:
    import torch

    from softgnss_tpu_torch.track import megakernel as mk

    r, c = cfg.track_block_ms, cfg.number_of_channels
    spc_w, win_w = cfg.samples_per_code // 4, cfg.track_window // 4
    rng = np.random.default_rng(SEED)
    n_words = r * spc_w + win_w + 3000
    cap = torch.from_numpy(rng.integers(-2**31, 2**31, n_words).astype(np.int32)).to(dev)
    starts = rng.integers(0, 2000, c)
    starts[0] = -7                                   # frames before the capture start
    starts[1] = n_words - (r - 1) * spc_w - win_w // 2   # the last frames run past the end
    starts = torch.from_numpy(starts.astype(np.int64)).to(dev)
    got = mk.build_frames(cap, starts, r, win_w, spc_w)
    want = mk.build_frames_plain(cap, starts, r, win_w, spc_w)
    torch.cuda.synchronize()
    check(got.shape == (r, c, win_w), f"B2 shape {tuple(got.shape)}")
    check(torch.equal(got, want), "B2 frames differ from the plain version")
    check(bool((got[0, 0, :2] == 0).all()) and bool((got[-1, 1, -2:] == 0).all()),
          "B2 zero fill")
    ms = cuda_ms(lambda: mk.build_frames(cap, starts, r, win_w, spc_w), 50)
    plain_ms = cuda_ms(lambda: mk.build_frames_plain(cap, starts, r, win_w, spc_w), 10)
    print(f"  frames {tuple(got.shape)} int32 bit-equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per block")
    return {"name": "build_frames", "route": "cuda",
            "source": "softgnss_tpu_torch/csrc/build_frames.cu",
            "replaces": "softgnss_tpu/track/megakernel.py:818",
            "max_abs_err": float((got.to(torch.int64) - want).abs().max()),
            "ms": ms, "plain_ms": plain_ms}


def run_split(cfg, words, channels, build, block):
    """PARITY_MS[0] ms, then a resumed PARITY_MS[1] ms (lead segment)."""
    import torch

    from softgnss_tpu_torch.track.scan import MsOutputs, initial_state, track_segments
    from softgnss_tpu_torch.track.tables import build_tables

    dev = words.device
    pads = build_tables(channels.prn, dev)
    active = torch.tensor([s == "T" for s in channels.status], device=dev)
    cb = torch.as_tensor(channels.acquired_freq).to(dev)
    st0 = initial_state(cfg, channels, dev)
    st1, ys1, ov1 = track_segments(cfg, words, st0, pads, cb, active,
                                   PARITY_MS[0], 0, build, block)
    st2, ys2, ov2 = track_segments(cfg, words, st1, pads, cb, active,
                                   PARITY_MS[1], PARITY_MS[0], build, block)
    check(int(torch.maximum(ov1, ov2).max()) == 0, "frame overflow")
    ys = MsOutputs(*[torch.cat(p).cpu().numpy() for p in zip(ys1, ys2)])
    return st0, st2, ys


def phase_b1(cfg, words, sats, dev) -> dict:
    import torch

    from softgnss_tpu_torch.acquire.search import Channels
    from softgnss_tpu_torch.track import megakernel as mk
    from softgnss_tpu_torch.track.scan import initial_state
    from softgnss_tpu_torch.track.tables import build_tables

    spc = cfg.samples_per_code
    status = ["T"] * (N_SATS - 1) + ["-"]
    channels = Channels(
        prn=np.asarray([s.prn for s in sats], np.int64),
        acquired_freq=np.asarray([cfg.intermediate_freq + s.doppler_hz for s in sats]),
        code_phase=np.asarray([int(round(s.delay_samples)) % spc for s in sats], np.int64),
        status=status)
    act = np.asarray([s == "T" for s in status])
    variant = dict(pdi_ms=4, fll_bandwidth_hz=10.0, carrier_aided_dll=True,
                   dll_correlator_spacing=0.25)
    worst = 0.0
    for label, c in (("default", cfg), ("variant", cfg.with_options(**variant))):
        st0, stk, yk = run_split(c, words, channels, mk.build_frames, mk.track_block)
        _, stp, yp = run_split(c, words, channels, mk.build_frames_plain,
                               mk.track_block_plain)
        check(np.array_equal(yk.absolute_sample, yp.absolute_sample),
              f"B1 {label}: absolute_sample differs")
        errs = {}
        for f in ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l"):
            a, b = getattr(yk, f)[:, act], getattr(yp, f)[:, act]
            errs[f] = float(np.abs(a - b).max() / np.sqrt(np.mean(b.astype(np.float64) ** 2)))
            check(errs[f] < TOL_CORR, f"B1 {label}: {f} rel err {errs[f]:.3e}")
            if label == "default":
                worst = max(worst, float(np.abs(a - b).max()))
        for f, tol in (("carr_freq", TOL_FREQ_HZ), ("code_freq", TOL_FREQ_HZ),
                       ("sample_frac", TOL_FRAC)):
            errs[f] = float(np.abs(getattr(yk, f) - getattr(yp, f)).max())
            check(errs[f] < tol, f"B1 {label}: {f} err {errs[f]:.3e}")
        # the inactive channel: zero outputs, state frozen
        for f in yk._fields:
            check(not np.any(getattr(yk, f)[:, ~act]), f"B1 {label}: idle {f} not zero")
        idle = ~torch.from_numpy(act).to(dev)
        for f, v0, v in zip(st0._fields, st0, stk):
            check(torch.equal(v0[idle], v[idle]), f"B1 {label}: idle channel state {f} moved")
        check(all(np.isfinite(getattr(yk, f)).all() for f in yk._fields),
              f"B1 {label}: non-finite outputs")
        print(f"  {label}: {sum(PARITY_MS)} ms x {N_SATS} ch, absolute_sample equal; "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    # one full block at the main path's shapes
    pads = build_tables(channels.prn, dev)
    active = torch.from_numpy(act).to(dev)
    cb = torch.as_tensor(channels.acquired_freq).to(dev)
    st = initial_state(cfg, channels, dev)
    r = cfg.track_block_ms
    start_w = torch.div(st.ptr - cfg.track_frame_pre, 4, rounding_mode="floor")
    frames = mk.build_frames(words, start_w, r, cfg.track_window // 4, spc // 4)
    args = (frames, 4 * start_w, st, pads, cb, active, cfg, r)
    ms = cuda_ms(lambda: mk.track_block(*args), 20)
    plain_ms = cuda_ms(lambda: mk.track_block_plain(*args), 3)
    print(f"  block r={r} x {N_SATS} ch: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"name": "track_block", "route": "cuda",
            "source": "softgnss_tpu_torch/csrc/track_block.cu",
            "replaces": "softgnss_tpu/track/megakernel.py:254",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_main(cfg, sig, sats, card: str) -> dict:
    from softgnss_tpu_torch.acquire.search import fine_freq_resolution
    from softgnss_tpu_torch.pipeline import run_receiver
    from softgnss_tpu_torch.track import megakernel as mk

    spc = cfg.samples_per_code
    B = cfg.track_block_ms
    n_segments = MAIN_MS // B + (MAIN_MS % B > 0)
    mk.build_frames.launches = 0
    mk.track_block.launches = 0
    res = run_receiver(cfg, signal=sig, n_ms=MAIN_MS, navigate=False, device=sig.device)
    launches = {"build_frames": mk.build_frames.launches,
                "track_block": mk.track_block.launches}
    print(res.summary())

    acq = res.acquisition
    injected = {s.prn for s in sats}
    got = set((np.flatnonzero(acq.acquired) + 1).tolist())
    check(injected <= got, f"acquired {sorted(got)}, injected {sorted(injected)}")
    tr = res.tracking
    check(set(tr.prn.tolist()) == injected and len(tr.prn) == N_SATS,
          f"channels hold {sorted(tr.prn.tolist())}")
    res_hz = fine_freq_resolution(cfg)
    for s in sats:
        cp = acq.code_phase[s.prn - 1]
        d = (cp - s.delay_samples) % spc
        check(min(d, spc - d) <= 1.0, f"PRN {s.prn}: code phase {cp} vs {s.delay_samples}")
        df = abs(acq.carr_freq[s.prn - 1] - (cfg.intermediate_freq + s.doppler_hz))
        check(df <= res_hz, f"PRN {s.prn}: fine freq off by {df:.2f} Hz")
    check(tr.n_ms == MAIN_MS, f"tracked {tr.n_ms} ms")
    by_prn = {s.prn: s for s in sats}
    for ch, prn in enumerate(tr.prn):
        ip, qp = np.abs(tr.i_p[ch, 300:]), np.abs(tr.q_p[ch, 300:])
        ratio = float(np.median(ip) / np.median(qp))
        ferr = abs(float(np.median(tr.carr_freq[ch, 300:]))
                   - cfg.intermediate_freq - by_prn[prn].doppler_hz)
        check(ratio > 5, f"ch {ch} PRN {prn}: median |I_P|/|Q_P| = {ratio:.2f}")
        check(ferr < 2.0, f"ch {ch} PRN {prn}: median carr_freq error {ferr:.3f} Hz")
        print(f"  ch {ch} PRN {int(prn):2d}: |I_P|/|Q_P| {ratio:7.2f}, "
              f"median carr_freq err {ferr:.4f} Hz")
    check(tr.status == ["T"] * N_SATS and np.isinf(tr.lock_loss_ms).all(),
          f"demoted channels: status {tr.status}")
    check(all(np.isfinite(getattr(tr, f)).all() for f in
              ("carr_freq", "code_freq", "i_p", "q_p", "sample_frac")), "non-finite tracking")
    check(launches == {"build_frames": n_segments, "track_block": n_segments},
          f"kernel launches {launches}, expected {n_segments} each")
    t_acq, t_trk = res.timings_s["acquire"], res.timings_s["track"]
    msps = MAIN_MS * spc / t_trk / 1e6
    print(f"  launches {launches} ({n_segments} segments)")
    print(f"  [{card}] acquire {t_acq:.3f} s, track {t_trk:.3f} s "
          f"({MAIN_MS} ms): {msps:.1f} capture Msamples/s, "
          f"{msps * N_SATS:.1f} channel-Msamples/s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.signals.synth import synthesize_signal
    from softgnss_tpu_torch.track import megakernel as mk
    from softgnss_tpu_torch.track.scan import capture_words

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("card"):
        name = torch.cuda.get_device_name(0)
        card = smi_line()
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")
        print(card)
    with phase("build"):
        lib = mk.load_library()
        print(f"  nvcc build {lib.build_s:.2f} s -> {lib.path}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())
    with phase("nco"):
        phase_nco(dev)
    cfg = default_config()
    with phase("B2 vs plain"):
        rec_b2 = phase_b2(cfg, dev)
    sats = make_scenario(cfg)
    with phase("synthesize"):
        sig = synthesize_signal(cfg, sats, CAPTURE_MS, noise_std=NOISE_STD,
                                seed=SEED, device=dev)
        torch.cuda.synchronize()
        print(f"  {CAPTURE_MS} ms, {sig.numel() / 1e9:.3f} GB int8 on {name}; PRNs "
              f"{[s.prn for s in sats]}")
    with phase("B1 vs plain"):
        rec_b1 = phase_b1(cfg, capture_words(sig), sats, dev)
    with phase("main path"):
        launches = phase_main(cfg, sig, sats, card)
    rec_b2["launches"] = launches["build_frames"]
    rec_b1["launches"] = launches["track_block"]
    print(json.dumps({"kernels": [rec_b2, rec_b1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
