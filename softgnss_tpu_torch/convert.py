"""Carry configurations, channel assignments, loop state, tracking
results and navigation output between the JAX package and this one,
through plain Python and NumPy values.

A JAX run's ``final_state`` (or a tracking checkpoint) resumes in the port
and the other way round::

    cfg = config_from_dict(dataclasses.asdict(jax_cfg))
    state = track_state_from_numpy(jax_results.final_state._asdict())
    track(cfg, signal, channels, n_ms, state=state)

and ``track_state_to_numpy(port_state)`` gives the ``{field: ndarray}``
form that ``softgnss_tpu.track.scan.TrackState(**d)`` takes.  A JAX
``TrackResults`` navigates in the port through
:func:`track_results_from_numpy`; either package's ``NavSolutions`` and
``Ephemeris`` become ``{field: value}`` dicts (and back, as the port's)
with :func:`nav_solutions_to_numpy` and :func:`ephemeris_to_dict`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.nav.message import Almanac, Ephemeris, UtcParams
from softgnss_tpu_torch.nav.solve import NavSolutions
from softgnss_tpu_torch.track.scan import _F32_FIELDS, MsOutputs, TrackResults, TrackState

#: JAX config fields that only lay work out on the TPU (capture packing,
#: Pallas tiling, scan unroll)
TPU_ONLY_FIELDS = frozenset({
    "track_pack_size", "pallas_contraction", "pallas_k_tiles",
    "track_tile", "track_unroll"})


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


def track_results_from_numpy(tr) -> TrackResults:
    """The port's TrackResults from a JAX ``TrackResults`` (or any object
    with its fields as arrays); its final state comes as CPU tensors."""
    state = tr.final_state
    if state is not None:
        state = track_state_from_numpy(state if isinstance(state, dict) else state._asdict())
    lock = getattr(tr, "lock_loss_ms", None)
    return TrackResults(prn=np.asarray(tr.prn), status=[str(s) for s in tr.status],
                        final_state=state,
                        lock_loss_ms=None if lock is None else np.asarray(lock),
                        **{f: np.asarray(getattr(tr, f)) for f in MsOutputs._fields})


def ephemeris_to_dict(eph) -> dict:
    """``{field: value}`` of either package's Ephemeris."""
    return {f.name: getattr(eph, f.name) for f in dataclasses.fields(Ephemeris)}


def ephemeris_from_dict(d: dict) -> Ephemeris:
    """The port's Ephemeris from :func:`ephemeris_to_dict`."""
    return Ephemeris(**d)


def nav_solutions_to_numpy(sol) -> dict:
    """``{field: value}`` of either package's NavSolutions: arrays as
    NumPy, ``utc_params`` as a dict and ``almanac`` as ``{prn: dict}``."""
    out = {}
    for f in dataclasses.fields(NavSolutions):
        v = getattr(sol, f.name, None)
        if f.name == "utc_params" and v is not None:
            v = dataclasses.asdict(v)
        elif f.name == "almanac" and v is not None:
            v = {int(prn): dataclasses.asdict(a) for prn, a in v.items()}
        elif isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def nav_solutions_from_numpy(d: dict) -> NavSolutions:
    """The port's NavSolutions from :func:`nav_solutions_to_numpy`."""
    d = dict(d)
    if d.get("utc_params") is not None:
        d["utc_params"] = UtcParams(**d["utc_params"])
    if d.get("almanac") is not None:
        d["almanac"] = {int(prn): Almanac(**a) for prn, a in d["almanac"].items()}
    return NavSolutions(**d)
