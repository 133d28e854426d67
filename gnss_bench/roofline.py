"""The table of peaks and the tracking work counted from its shapes.

Peaks of one NVIDIA H100 SXM at its 700-W limit (NVIDIA's data sheet):
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.  The
tracker's work is the same whatever implements it: every active channel
correlates every sample of every ms, 90 operations per correlated sample
(carrier NCO and its sine and cosine, three code lookups, six
multiply-adds, the code NCO), and the capture is read once.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_SAMPLE = 90


def track_ops(channels: int, n_ms: int, samples_per_code: int) -> float:
    return float(channels) * n_ms * samples_per_code * OPS_PER_SAMPLE


def track_bytes(n_ms: int, samples_per_code: int) -> float:
    """The int8 capture the tracker reads, each byte once."""
    return float(n_ms) * samples_per_code


def track_bound_s(channels: int, n_ms: int, samples_per_code: int) -> float:
    """The least time the card could take to track: the larger of the
    operations at peak FLOP/s and the bytes at peak bandwidth."""
    return max(track_ops(channels, n_ms, samples_per_code) / PEAK_FLOPS,
               track_bytes(n_ms, samples_per_code) / PEAK_BYTES)
