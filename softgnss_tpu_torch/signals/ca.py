"""GPS C/A (Gold) PRN codes (host NumPy; constant data).

The C/A code for PRN *p* is ``-G1 * delay(G2, d_p)`` with the two 10-stage
LFSRs of taps (3,10) and (2,3,6,8,9,10) and the per-PRN G2 delay
(reference: initialize.py:234-302).  Chips are +/-1 (binary 1 -> +1).
"""

from __future__ import annotations

import functools

import numpy as np

from softgnss_tpu_torch.config import ReceiverConfig

#: G2 delays per PRN (1-based PRN -> G2_DELAYS[prn-1]); entries past 32
#: serve non-GPS uses and are never searched (reference: initialize.py:251-255)
G2_DELAYS: tuple[int, ...] = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
    145, 175, 52, 21, 237, 235, 886, 657, 634, 762, 355, 1012, 176, 603, 130, 359, 595, 68,
    386,
)

_CODE_LEN = 1023


def _lfsr_sequence(tap_indices: tuple[int, ...]) -> np.ndarray:
    """Run a 10-stage +/-1 LFSR for 1023 chips; output is stage 9."""
    reg = -np.ones(10, np.int32)
    chips = np.empty(_CODE_LEN, np.int32)
    for i in range(_CODE_LEN):
        chips[i] = reg[9]
        fb = np.prod(reg[list(tap_indices)])
        reg[1:] = reg[:-1]
        reg[0] = fb
    return chips


@functools.cache
def gold_codes(num_prn: int = 32) -> np.ndarray:
    """All C/A codes as a (num_prn, 1023) int8 array of +/-1 chips (row i = PRN i+1)."""
    if num_prn > len(G2_DELAYS):
        raise ValueError(f"num_prn must be <= {len(G2_DELAYS)}")
    g1 = _lfsr_sequence((2, 9))
    g2 = _lfsr_sequence((1, 2, 5, 7, 8, 9))
    delays = np.asarray(G2_DELAYS[:num_prn], np.int32)
    idx = (np.arange(_CODE_LEN, dtype=np.int32)[None, :] - delays[:, None]) % _CODE_LEN
    return (-g1[None, :] * g2[idx]).astype(np.int8)


def gold_code(prn: int) -> np.ndarray:
    """C/A code for a single PRN (1-based), (1023,) int8 of +/-1."""
    if not 1 <= prn <= len(G2_DELAYS):
        raise ValueError(f"PRN must be in 1..{len(G2_DELAYS)}, got {prn}")
    return gold_codes(max(32, prn))[prn - 1]


def padded_code(prn: int) -> np.ndarray:
    """Code with one wraparound chip on each side, (1025,) int8:
    padded[0] = chip 1022, padded[i] = chip i-1, padded[1024] = chip 0, so a
    ceil'd chip phase c in [0, 1024] indexes the chip active over (c-1, c]
    (reference: tracking.py:109-111,166-188)."""
    code = gold_code(prn)
    return np.concatenate([code[-1:], code, code[:1]])


@functools.cache
def resample_indices(config: ReceiverConfig) -> np.ndarray:
    """Chip index of each sample of one code period, (samples_per_code,) int32:
    ``ceil(ts*(1..N)/tc) - 1`` with the last sample pinned to chip 1022
    (reference: initialize.py:223-226)."""
    n = config.samples_per_code
    ts = 1.0 / config.sampling_freq
    tc = 1.0 / config.code_freq_basis
    idx = np.ceil(ts * np.arange(1, n + 1, dtype=np.float64) / tc).astype(np.int64) - 1
    idx[-1] = _CODE_LEN - 1
    return idx.astype(np.int32)


@functools.cache
def ca_table(config: ReceiverConfig, num_prn: int = 32) -> np.ndarray:
    """All C/A codes resampled to the sampling rate, (num_prn, samples_per_code) f32."""
    return gold_codes(num_prn)[:, resample_indices(config)].astype(np.float32)
