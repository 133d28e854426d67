"""Time per op name of one 1 024-ms block-route tracking call, in us per ms.

Port of ``scripts/glue_trace.py``: one call of 12 channels over 1 024 ms
on the block route at ``track_block_ms=64`` (B2 + B1), one untimed call
first, then a ``torch.profiler`` trace of the next (``trace_track``'s
:func:`~softgnss_tpu_torch.scripts.trace_track.capture_trace`).  As the
JAX script summed every complete event of its trace by name, whatever its
lane, :func:`aggregate` sums the duration of every complete event by name:
kernels and copies on the card, torch ops, CUDA calls and the
``softgnss/`` ranges on the host (a range's time includes what runs
inside it).  The top 28 names are printed in us per ms tracked.
``trace_track`` splits the same trace into the card's and the host's
side.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.glue_trace

Without a CUDA card it raises.
"""

from __future__ import annotations

import sys
from collections import Counter

from softgnss_tpu_torch.config import default_config
from softgnss_tpu_torch.scripts.trace_track import capture_trace

N_CH = 12
N_MS = 1024
BLOCK_MS = 64
TOP = 28


def aggregate(events) -> Counter:
    """Total ``dur`` (us) by name over every complete (``ph`` 'X') event
    with a duration."""
    agg = Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            agg[e.get("name", "")] += e["dur"]
    return agg


def report(events, n_ms: int, top: int = TOP, card: str = "") -> list[str]:
    return [f"[{card}] {n_ms} ms; us per ms by name, every lane"] + [
        f"{tot / n_ms:9.3f} us/ms  {name[:100]}" for name, tot in aggregate(events).most_common(top)]


def main(argv=None) -> int:
    from softgnss_tpu_torch.scripts.inputs import sweep_inputs
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    dev = require_cuda()
    cfg = default_config(number_of_channels=N_CH, correlator_impl="megakernel",
                         track_block_ms=BLOCK_MS)
    inputs = sweep_inputs(cfg, N_CH, N_MS, dev, phase0=False, nav_bits=False)
    events = capture_trace(cfg, inputs.signal, inputs.channels, N_MS)
    print("\n".join(report(events, N_MS, card=card())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
