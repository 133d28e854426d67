"""Static per-channel code tables for the tracker.

On the GPU the correlator looks each sample's E/P/L chip up in the
1025-entry padded code held in shared memory — the reference formulation
(softgnss_tpu.track.scan._correlate_gather).  So of the JAX package's
tables only ``code_pads`` is needed; its one-hot tile tables and the
megakernel's per-lane joint words exist because TPU gathers are slow.
"""

from __future__ import annotations

import numpy as np
import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals import ca


def subdivision(config: ReceiverConfig) -> int:
    """Chip subdivision S: smallest integer with S*spacing integral >= 1
    (S=2 for the standard 0.5-chip spacing).  Raises for spacings with no
    subdivision <= 32."""
    d = config.dll_correlator_spacing
    for s in range(2, 33):
        ds = d * s
        if abs(ds - round(ds)) < 1e-9 and round(ds) >= 1:
            return s
    raise ValueError(
        f"dll_correlator_spacing={d} has no subdivision <= 32; use "
        "correlator_impl='gather'")


def build_tables(prns: np.ndarray, device="cpu") -> torch.Tensor:
    """(C, 1025) f32 padded codes (pad[i] = chip i-1) for 1-based ``prns``;
    idle channels (prn 0) get zero rows."""
    code_pads = np.zeros((len(prns), 1025), np.float32)
    for i, prn in enumerate(prns):
        if prn > 0:
            code_pads[i] = ca.padded_code(int(prn))
    return torch.from_numpy(code_pads).to(device)
