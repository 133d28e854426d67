"""The marginal per-ms cost of each tracking route, at 12 channels.

Port of ``scripts/profile_track.py``.  :func:`time_route` times one
tracking call (``scan.track_on_device``, the call ``scan.track`` makes) at
two scan lengths, ``n_short`` and ``n_long`` ms, and reports
``(T_long - T_short) / (n_long - n_short)``: the time one more ms costs,
with the fixed costs of a call (launch, allocation, the read-back) taken
out.  Each length runs once untimed first (the first call builds the
kernel library and plans), then ``reps`` times from the initial state with
its carrier phase moved by 1, 2, ... counts; the best rep counts.  Each
call ends on a read-back of the last ms's ``i_p`` and the final pointers,
which waits for every ms, and raises on a frame overflow.

A route is a spec ``B[,margin][,fused]``:

* ``B = 1`` — the per-ms route (B4 and the loop filters in torch,
  ``correlator_impl='pallas'``);
* ``B > 1`` — the block route (B2 + B1) at ``track_block_ms=B``;
  ``fused`` takes B3 in place of B2 + B1;
* ``margin`` — ``track_frame_margin`` (0: auto-sized).

The JAX script's spec ``B[,unroll[,margin[,pack]]]`` also set
``track_unroll`` and ``track_pack_size``, knobs of the TPU layout that the
port leaves out; a spec with three or four numbers is refused.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.profile_track [SPEC ...]

The default specs are ``1``, ``64`` and ``64,fused``, on
``default_config(number_of_channels=12)`` and the capture of
``inputs.sweep_inputs``.  Each line gives T_short and T_long, us per ms,
and capture and channel Msamples/s, beside nvidia-smi's card name and
power limit.  Without a CUDA card it raises.
"""

from __future__ import annotations

import math
import sys
import time
from typing import NamedTuple

from softgnss_tpu_torch.config import ReceiverConfig, default_config
from softgnss_tpu_torch.track.scan import (
    _check_overflow,
    channel_tables,
    initial_state,
    track_on_device,
)

N_CH = 12
N_SHORT, N_LONG = 200, 2000
DEFAULT_SPECS = ("1", "64", "64,fused")


class Spec(NamedTuple):
    block_ms: int
    margin: int = 0
    fused: bool = False


def parse_spec(text: str) -> Spec:
    """``B[,margin][,fused]`` as a :class:`Spec`; raises ValueError on
    anything else, the JAX script's unroll and pack fields included."""
    parts = [p.strip() for p in text.split(",")]
    fused = parts[-1] == "fused"
    nums = parts[:-1] if fused else parts
    if not 1 <= len(nums) <= 2 or not all(p.lstrip("-").isdigit() for p in nums):
        raise ValueError(
            f"spec {text!r}: expected B[,margin][,fused]; the JAX script's "
            "B,unroll,margin,pack also set track_unroll and track_pack_size, knobs of the "
            "TPU layout that the port leaves out")
    block_ms, margin = (int(p) for p in (*nums, "0")[:2])
    if block_ms < 1 or margin < 0:
        raise ValueError(f"spec {text!r}: B >= 1 and margin >= 0")
    if fused and block_ms == 1:
        raise ValueError(f"spec {text!r}: fused is a block route (B > 1)")
    return Spec(block_ms, margin, fused)


def spec_config(base: ReceiverConfig, spec: Spec) -> ReceiverConfig:
    """``base`` set to the route of ``spec``."""
    if spec.block_ms == 1:
        return base.with_options(correlator_impl="pallas", track_frame_margin=spec.margin)
    return base.with_options(correlator_impl="megakernel", track_block_ms=spec.block_ms,
                             track_frame_margin=spec.margin, mega_fused_frames=spec.fused)


def route_name(config: ReceiverConfig) -> str:
    if config.tracker == "per_ms":
        return "per-ms (B4)"
    return "fused (B3)" if config.mega_fused_frames else "block (B2 + B1)"


def time_route(config: ReceiverConfig, signal, channels, n_short: int = N_SHORT,
               n_long: int = N_LONG, reps: int = 3, track=track_on_device, check=None):
    """Time ``track`` (``scan.track_on_device``'s signature) over ``n_short``
    and ``n_long`` ms of ``signal`` from ``channels``' initial state on the
    device ``signal`` lies on.  ``check(n_ms, final_state, outputs)``, when
    given, sees each length's untimed first call before its reps are timed
    (``reps=0`` runs those calls alone, for their outputs).  Returns
    ``({n_short: best s, n_long: best s}, s per ms)``."""
    if not 0 < n_short < n_long:
        raise ValueError(f"scan lengths {n_short}, {n_long}: need 0 < n_short < n_long")
    dev = signal.device
    need = config.skip_samples + (n_long + 2) * config.samples_per_code
    if signal.shape[0] < need:
        raise ValueError(f"capture too short for {n_long} ms: need >= {need} samples, "
                         f"got {signal.shape[0]}")
    tables = channel_tables(channels, dev)
    state0 = initial_state(config, channels, dev)

    def run(n_ms, st):
        final, ys, ovf = track(config, signal, tables, st, n_ms, 0)
        _check_overflow(ovf)
        # a value that depends on every ms: the call has ended when it is read
        float(ys.i_p[-1].sum()) + float(final.ptr.sum())
        return final, ys

    times = {}
    for n_ms in (n_short, n_long):
        final, ys = run(n_ms, state0)
        if check is not None:
            check(n_ms, final, ys)
        best = math.inf
        for r in range(reps):
            st = state0._replace(carr_phase=state0.carr_phase + (r + 1))
            t0 = time.perf_counter()
            run(n_ms, st)
            best = min(best, time.perf_counter() - t0)
        times[n_ms] = best
    return times, (times[n_long] - times[n_short]) / (n_long - n_short)


def describe(label: str, config: ReceiverConfig, times: dict, per_ms_s: float, n_ch: int) -> str:
    """One line of figures: T_short, T_long, us per ms, capture and channel
    Msamples/s."""
    (n_short, t_short), (n_long, t_long) = sorted(times.items())
    msps = config.samples_per_code / per_ms_s / 1e6
    return (f"{label}: win={config.track_window} pre={config.track_frame_pre}  "
            f"T{n_short}={t_short * 1e3:.3f} ms T{n_long}={t_long * 1e3:.3f} ms  "
            f"per-ms={per_ms_s * 1e6:.3f} us -> {msps:.1f} capture Msamples/s, "
            f"{msps * n_ch:.1f} channel-Msamples/s")


def main(argv=None) -> int:
    from softgnss_tpu_torch.scripts.inputs import sweep_inputs
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    argv = sys.argv[1:] if argv is None else argv
    specs = [parse_spec(a) for a in (argv or DEFAULT_SPECS)]
    dev = require_cuda()
    base = default_config(number_of_channels=N_CH)
    inputs = sweep_inputs(base, N_CH, N_LONG, dev)
    print(f"{N_CH} channels, samples_per_code {base.samples_per_code} [{card()}]")
    for spec in specs:
        cfg = spec_config(base, spec)
        times, per_ms = time_route(cfg, inputs.signal, inputs.channels)
        label = f"B={spec.block_ms:4d} m={spec.margin:4d} {route_name(cfg)}"
        print(f"{describe(label, cfg, times, per_ms, N_CH)} [{card()}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
