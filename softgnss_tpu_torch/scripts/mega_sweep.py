"""The block route's marginal per-ms cost by block size and cluster size.

Port of ``scripts/mega_sweep.py``, which swept the TPU block tracker's
``track_block_ms`` against ``pallas_k_tiles``, the number of tiles one
channel's window was split into.  On the H100 that split is B1's cluster
size: each channel runs on one thread-block cluster of kN CTAs, each CTA
summing its slice of every ms window (``megakernel.rank_slices``).  So the
TPU points (64, 38) (64, 76) (128, 38) (128, 76) (256, 76) (64, 19) are
here (64, 8) (64, 16) (128, 8) (128, 16) (256, 16) (64, 4): the default
kN = 16 in place of 76 tiles, and each other tile count scaled with it.

The block size sets the number of B2 + B1 launch pairs and so the host
work per call; the cluster size how B1 spreads over the SMs (at 12
channels 12 clusters of 16 CTAs do not all fit on 132 SMs at once).  A
point passes kN to B1 as ``chip_smoke.py`` does (``track_segments`` with
``functools.partial(track_block, ctas_per_channel=kN)``); the receiver's
own ``track`` picks the size itself.

Each point is timed by ``profile_track.time_route`` (the marginal cost of
one more ms between two scan lengths), after its outputs at both lengths
are held bit-equal to the reference point (64, 16)'s: the block and
cluster sizes move frames and slices, not which samples are summed, and B1
sums in float64 and rounds once.  A point whose cluster size this card
refuses (``megakernel.choose_ctas_per_channel`` on its occupancy) is
skipped with the reason; any other error propagates.

Run on a CUDA card from the repository root::

    CH=12 MS=2000 python -m softgnss_tpu_torch.scripts.mega_sweep [B,kN ...]

``CH`` (channels, default 12) and ``MS`` (the long scan, default 2000 ms;
the short one is max(256, MS/8)) come from the environment; arguments
replace the default points.  Without a CUDA card it raises.
"""

from __future__ import annotations

import functools
import os
import sys
import warnings

import torch

from softgnss_tpu_torch.config import ReceiverConfig, default_config
from softgnss_tpu_torch.scripts.inputs import assert_bit_equal
from softgnss_tpu_torch.scripts.profile_track import describe, time_route
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track.scan import capture_words, track_segments

#: (track_block_ms, CTAs per channel) of the JAX script's points, kN for k_tiles
POINTS = ((64, 8), (64, 16), (128, 8), (128, 16), (256, 16), (64, 4))
#: the point every other is held bit-equal to: the receiver's defaults
REFERENCE = (64, 16)


def point_track(kn: int):
    """``scan.track_on_device``'s block route (B2 + B1) with B1 launched at
    ``kn`` CTAs per channel."""
    block = functools.partial(mk.track_block, ctas_per_channel=kn)

    def track(config, signal, tables, state, n_ms, start_ms):
        code_pads, carr_basis, active = tables
        return track_segments(config, capture_words(signal), state, code_pads, carr_basis,
                              active, n_ms, start_ms, mk.build_frames, block)

    return track


def refusal(config: ReceiverConfig, device, kn: int) -> str | None:
    """Why this card cannot run B1 at ``kn`` CTAs per channel, or None:
    ``megakernel.choose_ctas_per_channel`` on the card's occupancy, asked for
    one cluster of ``kn``, refuses it or steps down.  None on the CPU, where
    the plain version runs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, win = mk.THREADS_PER_CTA, config.track_window

    def fits(k):
        return mk.max_active_clusters(index, False, k, threads, mk.rank_chunk(win, k))

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            chosen = mk.choose_ctas_per_channel(1, fits, preferred=kn)
    except RuntimeError as exc:
        return str(exc)
    if chosen != kn:
        return f"no cluster of {kn} CTAs of B1 fits on this card (it would take {chosen})"
    return None


def sweep(base: ReceiverConfig, signal, channels, points=POINTS, reference=REFERENCE,
          n_short: int = 256, n_long: int = 2000, reps: int = 3, report=print) -> dict:
    """Every point of ``points`` on ``base`` (the block route, B2 + B1):
    ``{(block_ms, kN): (times, s per ms)}`` from ``profile_track.time_route``,
    or the refusal (a string) of a skipped point.  Each point's outputs
    are held bit-equal to ``reference``'s before it is timed.  ``report``
    gets one line per point."""
    base = base.with_options(correlator_impl="megakernel", mega_fused_frames=False)
    dev = signal.device
    want = {}

    def keep(n_ms, final, ys):
        want[n_ms] = ys._asdict()

    ref_cfg = base.with_options(track_block_ms=reference[0])
    time_route(ref_cfg, signal, channels, n_short, n_long, reps=0,
               track=point_track(reference[1]), check=keep)
    out = {}
    for block_ms, kn in points:
        cfg = base.with_options(track_block_ms=block_ms)
        label = f"block_ms={block_ms:4d} kN={kn:2d}"
        why = refusal(cfg, dev, kn)
        if why is not None:
            report(f"{label}: skipped: {why}")
            out[(block_ms, kn)] = why
            continue

        def check(n_ms, final, ys, label=label):
            assert_bit_equal(f"{label} at {n_ms} ms against {reference}", ys._asdict(),
                             want[n_ms])

        times, per_ms = time_route(cfg, signal, channels, n_short, n_long, reps,
                                   track=point_track(kn), check=check)
        out[(block_ms, kn)] = (times, per_ms)
        report(describe(label, cfg, times, per_ms, len(channels)) + ", bit-equal to "
               f"{reference}")
    return out


def short_length(n_long: int) -> int:
    """The short scan of a sweep whose long scan is ``n_long`` ms."""
    return max(256, n_long // 8)


def parse_point(text: str) -> tuple[int, int]:
    """``B,kN`` as (track_block_ms, CTAs per channel)."""
    parts = text.split(",")
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise ValueError(f"point {text!r}: expected B,kN")
    block_ms, kn = (int(p) for p in parts)
    if kn not in mk.CLUSTER_SIZES or block_ms < 2:
        raise ValueError(f"point {text!r}: kN one of {mk.CLUSTER_SIZES}, B >= 2")
    return block_ms, kn


def main(argv=None) -> int:
    from softgnss_tpu_torch.scripts.inputs import sweep_inputs
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    argv = sys.argv[1:] if argv is None else argv
    points = tuple(parse_point(a) for a in argv) or POINTS
    n_ch = int(os.environ.get("CH", "12"))
    n_ms = int(os.environ.get("MS", "2000"))
    dev = require_cuda()
    base = default_config(number_of_channels=n_ch)
    inputs = sweep_inputs(base, n_ch, n_ms, dev, nav_bits=False)
    print(f"{n_ch} channels, {short_length(n_ms)} and {n_ms} ms [{card()}]")
    sweep(base, inputs.signal, inputs.channels, points, n_short=short_length(n_ms),
          n_long=n_ms, report=lambda line: print(f"{line} [{card()}]", flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
