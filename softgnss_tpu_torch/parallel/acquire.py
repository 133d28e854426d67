"""Mesh-sharded acquisition: the PRN axis of the search grid partitioned
over the mesh's channel dimension (softgnss_tpu.parallel.acquire).

The (PRN x Doppler x code-phase) search is independent per PRN; only the
Doppler-mixed signal FFTs are shared.  Every rank computes them, then runs
``acquire.search._prn_block`` (through ``_acquire_device``, the function
the one-device path runs) on its own PRN rows; the per-PRN results are
gathered over the channel dimension, so every rank returns the whole
result.
"""

from __future__ import annotations

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import (
    AcquisitionResults,
    _acquire_device,
    hint_bin_mask,
    per_prn_results,
)
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.device import place
from softgnss_tpu_torch.parallel.mesh import all_gather_host, mesh_position, run_together


def acquire_sharded(config: ReceiverConfig, long_signal, mesh,
                    doppler_hints: np.ndarray | None = None,
                    hint_halfwidth_hz: float = 500.0, device=None) -> AcquisitionResults:
    """Acquisition with the PRN search sharded over ``mesh``'s channel
    dimension; every rank of the mesh calls it with the same arguments and
    gets the same :class:`AcquisitionResults` as
    :func:`softgnss_tpu_torch.acquire.acquire` (same math, other batches).

    ``doppler_hints`` restrict each PRN's Doppler bins as on one device; the
    (PRN, bin) mask shards with the PRN axis.  The PRN list is padded to a
    multiple of the dimension's size with repeats of its first PRN
    (discarded after the gather).  ``device``: where this rank computes, by
    :func:`softgnss_tpu_torch.device.place`'s rule."""
    need = config.acquisition_ms * config.samples_per_code
    if long_signal.shape[0] < need:
        raise ValueError(f"acquisition needs {need} samples, got {long_signal.shape[0]}")
    pos = mesh_position(config, mesh)
    prn_list = np.asarray(config.acq_satellite_list, np.int64)
    n_prn = len(prn_list)
    pad = (-n_prn) % pos.n_c
    per = (n_prn + pad) // pos.n_c
    rows = slice(pos.c * per, (pos.c + 1) * per)
    mine = np.concatenate([prn_list, prn_list[:1].repeat(pad)])[rows]
    mask = hint_bin_mask(config, doppler_hints, hint_halfwidth_hz)
    if mask is not None:
        mask = np.concatenate([mask, mask[:1].repeat(pad, axis=0)])[rows]

    def local():
        sig = place(long_signal[:need], device)
        bins = None if mask is None else torch.from_numpy(mask).to(sig.device)
        return _acquire_device(config, sig, bins, prns=mine), 0

    out, _ = run_together(local)
    if pos.n_c > 1:
        parts = all_gather_host(list(out), pos.channel_group)
        out = [torch.cat(leaf) for leaf in zip(*parts)]
    return per_prn_results(config, [v.cpu().numpy()[:n_prn] for v in out])
