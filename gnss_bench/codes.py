"""GPS L1 C/A codes, the benchmark's own copy (IS-GPS-200, section 3.3.2.3).

Each code is the product of two 10-stage maximal-length sequences, G1
(feedback taps 3 and 10) and G2 (taps 2, 3, 6, 8, 9 and 10), with G2
delayed by a per-PRN number of chips (IS-GPS-200 Table 3-Ia).  Chips are
+1 for a binary 1 and -1 for a binary 0, the sign SoftGNSS's
generateCAcode gives its replica (the receiver's correlator signs follow
it).  Used by the capture generator and
by the reference; nothing here comes from the program under test.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023

#: G2 delay in chips of PRN 1..32 (IS-GPS-200 Table 3-Ia)
G2_DELAY = (5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256, 257, 258,
            469, 470, 471, 472, 473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
            861, 862)


def _m_sequence(taps: tuple[int, ...]) -> np.ndarray:
    """1023 output bits (stage 10) of a 10-stage LFSR started all ones."""
    reg = [1] * 10
    out = np.empty(CODE_LENGTH, np.int8)
    for i in range(CODE_LENGTH):
        out[i] = reg[9]
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        reg = [fb] + reg[:9]
    return out


@functools.cache
def gold_codes() -> np.ndarray:
    """(32, 1023) int8 +/-1 chips; row i is PRN i + 1."""
    g1 = _m_sequence((3, 10))
    g2 = _m_sequence((2, 3, 6, 8, 9, 10))
    rows = []
    for d in G2_DELAY:
        bits = g1 ^ np.roll(g2, d)
        rows.append(2 * bits.astype(np.int8) - 1)
    return np.stack(rows).astype(np.int8)
