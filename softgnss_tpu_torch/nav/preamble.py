"""Bit/frame synchronization: locate the TLM preamble in tracked I_P.

The port of softgnss_tpu.nav.preamble (reference postNavigation.py:
524-631): correlate the sign of the prompt-correlator output with the
20-ms-upsampled 8-bit preamble, keep candidates with |correlation| > 153,
and confirm a candidate iff another lies exactly 6000 ms later AND the two
30-bit words starting there pass parity after 20-ms bit integration.
Channels are indexed by channel number (the reference indexes by position
in its active list, postNavigation.py:566-570).  Host NumPy: the
correlation is an exact integer one per channel.
"""

from __future__ import annotations

import numpy as np

from softgnss_tpu_torch.nav.message import PREAMBLE_BITS
from softgnss_tpu_torch.nav.parity import nav_parity_check

#: ms-domain detection threshold (reference: postNavigation.py:586)
_XCORR_THRESHOLD = 153
_MS_PER_BIT = 20
_SUBFRAME_MS = 6000
_KERNEL = np.repeat(2 * np.asarray(PREAMBLE_BITS) - 1, _MS_PER_BIT).astype(np.int64)


def _confirm(i_p: np.ndarray, idx: np.ndarray) -> int:
    """First candidate index confirmed by 6000-ms spacing + double parity."""
    spaced = idx[np.isin(idx + _SUBFRAME_MS, idx)]
    # need 40 ms of history (2 star bits) and 60 bits ahead
    spaced = spaced[(spaced >= 40) & (spaced + _MS_PER_BIT * 60 <= len(i_p))]
    if spaced.size == 0:
        return 0
    # integrate 62 bits (2 previous + TLM + HOW) for every candidate at once
    windows = np.stack([i_p[i - 40:i + _MS_PER_BIT * 60] for i in spaced])
    bits = windows.reshape(len(spaced), 62, _MS_PER_BIT).sum(axis=2)
    bits = np.where(bits > 0, 1, -1)
    ok = (nav_parity_check(bits[:, 0:32]) != 0) & (nav_parity_check(bits[:, 30:62]) != 0)
    hits = spaced[ok]
    return int(hits[0]) if hits.size else 0


def find_preambles(i_p: np.ndarray, status: list[str],
                   search_start_offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Find the first confirmed preamble per channel.

    ``i_p``: (C, n_ms) prompt correlator outputs; ``status``: per-channel
    'T'/'-'.  Returns (first_subframe (C,) int — 0 if none, active channel
    indices).
    """
    i_p = np.asarray(i_p)
    n_ch = i_p.shape[0]
    first_subframe = np.zeros(n_ch, np.int64)
    tracked = [c for c in range(n_ch) if status[c] != "-"]
    active = []
    for c in tracked:
        signs = np.where(i_p[c, search_start_offset:] > 0, 1, -1)
        xcorr = np.correlate(signs, _KERNEL, mode="valid")
        idx = (np.abs(xcorr) > _XCORR_THRESHOLD).nonzero()[0] + search_start_offset
        hit = _confirm(i_p[c], idx)
        if hit:
            first_subframe[c] = hit
            active.append(c)
    return first_subframe, np.asarray(active, np.int64)
