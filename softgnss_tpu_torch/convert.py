"""Carry configurations, channel assignments and loop state between the
JAX package and this one, through plain Python and NumPy values.

A JAX run's ``final_state`` (or a tracking checkpoint) resumes in the port
and the other way round::

    cfg = config_from_dict(dataclasses.asdict(jax_cfg))
    state = track_state_from_numpy(jax_results.final_state._asdict())
    track(cfg, signal, channels, n_ms, state=state)

and ``track_state_to_numpy(port_state)`` gives the ``{field: ndarray}``
form that ``softgnss_tpu.track.scan.TrackState(**d)`` takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.track.scan import _F32_FIELDS, TrackState

#: JAX config fields that only lay work out on the TPU (capture packing,
#: Pallas tiling, fused frames, mesh axis names, scan unroll)
TPU_ONLY_FIELDS = frozenset({
    "track_pack_size", "pallas_contraction", "pallas_k_tiles",
    "mega_fused_frames", "time_axis", "channel_axis", "track_tile",
    "track_unroll"})


def config_from_dict(d: dict) -> ReceiverConfig:
    """A ReceiverConfig from ``dataclasses.asdict`` of either package's
    config; TPU-only fields are dropped, any other unknown field raises."""
    known = {f.name for f in dataclasses.fields(ReceiverConfig)}
    unknown = set(d) - known - TPU_ONLY_FIELDS
    if unknown:
        raise ValueError(f"unknown config fields: {sorted(unknown)}")
    return ReceiverConfig(**{k: v for k, v in d.items() if k in known})


def channels_from_numpy(prn, acquired_freq, code_phase, status) -> Channels:
    """Channels from plain arrays (``status``: sequence of 'T' / '-')."""
    return Channels(prn=np.asarray(prn, np.int64),
                    acquired_freq=np.asarray(acquired_freq, np.float64),
                    code_phase=np.asarray(code_phase, np.int64),
                    status=[str(s) for s in status])


def track_state_from_numpy(d: dict, device="cpu") -> TrackState:
    """TrackState of tensors on ``device`` from ``{field: ndarray}``; the
    float32 accumulator leaves default to zero when absent (checkpoints
    written before coherent integration existed)."""
    shape = np.shape(d["ptr"])
    return TrackState(**{
        f: torch.as_tensor(np.array(d[f]) if f in d
                           else np.zeros(shape, np.float32)).to(device)
        for f in TrackState._fields if f in d or f in _F32_FIELDS})


def track_state_to_numpy(state: TrackState) -> dict:
    """``{field: ndarray}`` of a TrackState (any device)."""
    return {f: v.cpu().numpy() for f, v in state._asdict().items()}
