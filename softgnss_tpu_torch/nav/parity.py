"""IS-GPS-200 Hamming(32,26) nav-word parity: vectorized check + encoder.

NumPy, carried over from softgnss_tpu.nav.parity unchanged.

The GPS nav message transmits 30-bit words: 24 data bits XOR'd with the
previous word's last parity bit (D30*), followed by 6 parity bits computed
from the *source* data bits and the previous word's D29*/D30*.

The check follows the GPS SPS Signal Spec Figure 2-10 flowchart (the same
procedure as reference postNavigation.py:443-521) in the +/-1 domain
(binary 1 -> +1, binary 0 -> -1, XOR -> sign products), but runs as one
einsum-style masked product over an arbitrary batch of words instead of a
per-word Python function — checking every candidate word of every channel
at once.

The encoder is the exact inverse (it exists because the framework must
*synthesize* decodable signals — the reference has no encoder and no test
data, SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

#: participation masks of the six parity bits D25..D30 over the 32-vector
#: [D29*, D30*, d1..d24, D25..D30-received]; indices 0..25 only
#: (GPS SPS spec table; same index sets as reference postNavigation.py:485-508)
PARITY_MASKS: tuple[tuple[int, ...], ...] = (
    (0, 2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22, 25),
    (0, 2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (1, 2, 4, 6, 7, 8, 10, 11, 15, 16, 17, 18, 19, 22, 23, 25),
    (0, 4, 6, 7, 9, 10, 11, 12, 14, 16, 20, 23, 24, 25),
)

#: (6, 26) 0/1 participation matrix over [D29*, D30*, d1..d24]
_MASK_MATRIX = np.zeros((6, 26), np.int8)
for _row, _idx in enumerate(PARITY_MASKS):
    _MASK_MATRIX[_row, list(_idx)] = 1


def nav_parity_check(ndat: np.ndarray) -> np.ndarray:
    """Parity-check one or many 32-bit nav words in the +/-1 domain.

    ``ndat``: (..., 32) of +/-1 — [D29*, D30*, D1..D30] as received (i.e.
    data bits still XOR'd with D30*).  Returns (...,) int: +1 if parity
    passes and bits D1..D24 have true polarity, -1 if they must be
    inverted, 0 on parity failure.  Invariant under a global sign flip of
    the whole stream (the PLL's 180-degree ambiguity), like the reference
    checker (postNavigation.py:474-515).
    """
    ndat = np.asarray(ndat)
    if ndat.shape[-1] != 32:
        raise ValueError(f"nav words are 32 bits, got {ndat.shape[-1]}")
    d30s = ndat[..., 1:2]
    # undo the D30* XOR of the data bits: in +/-1, XOR with binary-0 D30*
    # (-1) is a sign flip of the data per the spec flowchart
    data = np.where(d30s != 1, -ndat[..., 2:26], ndat[..., 2:26])
    vec = np.concatenate([ndat[..., 0:2], data], axis=-1)  # (..., 26)
    # product over each mask == XOR chain; mask via exponentiation by 0/1
    terms = np.where(_MASK_MATRIX.astype(bool), vec[..., None, :], 1)
    parity = terms.prod(axis=-1)                            # (..., 6)
    ok = (parity == ndat[..., 26:32]).all(axis=-1)
    return np.where(ok, -ndat[..., 1], 0).astype(np.int64)


def encode_word(source24: np.ndarray, d29star: int, d30star: int) -> np.ndarray:
    """Encode one 30-bit transmitted word from 24 source bits (0/1).

    ``d29star``/``d30star`` are the previous transmitted word's last two
    parity bits (0/1).  Returns (30,) 0/1 transmitted bits such that
    :func:`nav_parity_check` passes and the standard receiver-side D30*
    correction recovers ``source24``.
    """
    source24 = np.asarray(source24, np.int8)
    if source24.shape != (24,):
        raise ValueError("source24 must be 24 bits")
    # the checker computes products over [D29*, D30*, complement(source)]
    # in +/-1; solve for the parity bits that make it pass
    vec01 = np.concatenate([[d29star, d30star], 1 - source24])
    vec = 2 * vec01.astype(np.int8) - 1
    terms = np.where(_MASK_MATRIX.astype(bool), vec[None, :], 1)
    parity_pm = terms.prod(axis=-1)                         # (6,) +/-1
    parity01 = ((parity_pm + 1) // 2).astype(np.int8)
    data01 = source24 ^ np.int8(d30star)
    return np.concatenate([data01, parity01])


def encode_stream(source_words: np.ndarray, d29star: int = 0, d30star: int = 0) -> np.ndarray:
    """Encode a sequence of 24-bit source words into transmitted bits.

    ``source_words``: (W, 24) 0/1.  Returns (W*30,) 0/1 transmitted bits,
    chaining D29*/D30* across words.
    """
    out = np.empty((len(source_words), 30), np.int8)
    for i, word in enumerate(source_words):
        out[i] = encode_word(word, d29star, d30star)
        d29star, d30star = int(out[i, 28]), int(out[i, 29])
    return out.reshape(-1)
