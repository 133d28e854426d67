"""GPS LNAV message codec: subframe encoder + ephemeris decoder.

NumPy, carried over from softgnss_tpu.nav.message unchanged.

Decoder capability matches reference ephemeris.py:60-195 (subframes 1-3 ->
clock + ephemeris fields, TOW from the HOW of the last subframe); the
encoder is new — it produces transmitted bit streams (with correct parity
chaining and D30* data inversion) that feed the signal synthesizer, giving
the framework the closed-loop nav test path the reference lacks (SURVEY.md
§4).

Bit positions are 0-based indices into the 300-bit subframe of *source*
(polarity-corrected) bits, identical to the reference's string slices
(ephemeris.py:110-173).

Documented divergences from the reference (per SURVEY.md §7 "quirks
policy" — the reference's slices here are internally inconsistent):

* T_GD: the reference reads 9 bits [195:204] (ephemeris.py:123) — one bit
  early for the ICD's 8-bit field [196:204], overlapping its own IODC
  low-byte slice.  We use the ICD field [196:204], 8 bits, scale 2^-31.
* IODC low byte: the reference reads [196:204] (the T_GD bits!)
  (ephemeris.py:125); the ICD places it at word 8 bits 1-8 = [210:218].
  We use [210:218].

Everything else (week number +1024, all scales, split fields, TOW*6-30)
matches the reference exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from softgnss_tpu_torch.nav.parity import encode_stream

#: pi as defined for the GPS coordinate system (reference: ephemeris.py:95)
GPS_PI = 3.1415926535898

#: TLM preamble, 0/1 MSB first (10001011; reference: postNavigation.py:556)
PREAMBLE_BITS: tuple[int, ...] = (1, 0, 0, 0, 1, 0, 1, 1)

_SUBFRAME_BITS = 300
_WORDS = 10
_SECONDS_PER_SUBFRAME = 6


@dataclass
class Ephemeris:
    """Broadcast clock + ephemeris of one satellite.

    Field set identical to the reference's 27-field eph recarray
    (postNavigation.py:118-121); None marks a field whose subframe was
    not decoded.
    """

    week_number: int | None = None
    accuracy: int | None = None
    health: int | None = None
    t_gd: float | None = None
    iodc: int | None = None
    t_oc: float | None = None
    a_f2: float | None = None
    a_f1: float | None = None
    a_f0: float | None = None
    iode_sf2: int | None = None
    c_rs: float | None = None
    delta_n: float | None = None
    m_0: float | None = None
    c_uc: float | None = None
    e: float | None = None
    c_us: float | None = None
    sqrt_a: float | None = None
    t_oe: float | None = None
    c_ic: float | None = None
    omega_0: float | None = None
    c_is: float | None = None
    i_0: float | None = None
    c_rc: float | None = None
    omega: float | None = None
    omega_dot: float | None = None
    iode_sf3: int | None = None
    i_dot: float | None = None

    @property
    def complete(self) -> bool:
        """Usable for satpos: needs IODC + both IODEs decoded
        (reference gate: postNavigation.py:142-146)."""
        return self.iodc is not None and self.iode_sf2 is not None and self.iode_sf3 is not None


# --- field layout tables ----------------------------------------------------
# (field, [(start, nbits), ...], scale, signed); value = int(bits) * scale.
# pi-scaled angles use scale * GPS_PI.  Slices are 0-based [start, start+n).
_S = [("week_number", [(60, 10)], 1, False),       # decoder adds 1024
      ("accuracy", [(72, 4)], 1, False),
      ("health", [(76, 6)], 1, False),
      ("iodc", [(82, 2), (210, 8)], 1, False),     # ICD position (see module doc)
      ("t_gd", [(196, 8)], 2.0 ** -31, True),      # ICD position (see module doc)
      ("t_oc", [(218, 16)], 2.0 ** 4, False),
      ("a_f2", [(240, 8)], 2.0 ** -55, True),
      ("a_f1", [(248, 16)], 2.0 ** -43, True),
      ("a_f0", [(270, 22)], 2.0 ** -31, True)]
_SUBFRAME_1 = _S

_SUBFRAME_2 = [
    ("iode_sf2", [(60, 8)], 1, False),
    ("c_rs", [(68, 16)], 2.0 ** -5, True),
    ("delta_n", [(90, 16)], 2.0 ** -43 * GPS_PI, True),
    ("m_0", [(106, 8), (120, 24)], 2.0 ** -31 * GPS_PI, True),
    ("c_uc", [(150, 16)], 2.0 ** -29, True),
    ("e", [(166, 8), (180, 24)], 2.0 ** -33, False),
    ("c_us", [(210, 16)], 2.0 ** -29, True),
    ("sqrt_a", [(226, 8), (240, 24)], 2.0 ** -19, False),
    ("t_oe", [(270, 16)], 2.0 ** 4, False),
]

_SUBFRAME_3 = [
    ("c_ic", [(60, 16)], 2.0 ** -29, True),
    ("omega_0", [(76, 8), (90, 24)], 2.0 ** -31 * GPS_PI, True),
    ("c_is", [(120, 16)], 2.0 ** -29, True),
    ("i_0", [(136, 8), (150, 24)], 2.0 ** -31 * GPS_PI, True),
    ("c_rc", [(180, 16)], 2.0 ** -5, True),
    ("omega", [(196, 8), (210, 24)], 2.0 ** -31 * GPS_PI, True),
    ("omega_dot", [(240, 24)], 2.0 ** -43 * GPS_PI, True),
    ("iode_sf3", [(270, 8)], 1, False),
    ("i_dot", [(278, 14)], 2.0 ** -43 * GPS_PI, True),
]

_LAYOUTS = {1: _SUBFRAME_1, 2: _SUBFRAME_2, 3: _SUBFRAME_3}
_INT_FIELDS = {"week_number", "accuracy", "health", "iodc", "iode_sf2", "iode_sf3"}
#: angle fields in semicircles: wrapped into [-pi, pi) before encoding (the
#: two's-complement semicircle representation covers exactly one turn)
_ANGLE_FIELDS = {"m_0", "omega_0", "omega", "i_0"}


def _bits_to_uint(bits: np.ndarray) -> int:
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


def _bits_to_int(bits: np.ndarray) -> int:
    """Two's-complement read, MSB first (reference: ephemeris.py:7-24)."""
    v = _bits_to_uint(bits)
    if bits[0]:
        v -= 1 << len(bits)
    return v


def _uint_to_bits(value: int, n: int) -> np.ndarray:
    if not 0 <= value < (1 << n):
        raise ValueError(f"value {value} does not fit in {n} unsigned bits")
    return np.asarray([(value >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def _int_to_bits(value: int, n: int) -> np.ndarray:
    lo, hi = -(1 << (n - 1)), (1 << (n - 1)) - 1
    if not lo <= value <= hi:
        raise ValueError(f"value {value} does not fit in {n} signed bits")
    return _uint_to_bits(value & ((1 << n) - 1), n)


def encode_subframe_source(subframe_id: int, tow_count_next: int,
                           eph: Ephemeris,
                           iono: np.ndarray | None = None,
                           utc: "UtcParams | None" = None,
                           almanac_page: "Almanac | None" = None) -> np.ndarray:
    """Source (pre-parity) bits of one subframe, (300,) 0/1.

    Parity-region bits (positions w*30+24 .. w*30+29) are left 0 here; the
    transmitted parity replaces them in :func:`build_nav_stream`.
    ``tow_count_next`` is the 17-bit Z-count of the *next* subframe start,
    as the ICD transmits it (reference decodes TOW*6-30, ephemeris.py:190).
    """
    bits = np.zeros(_SUBFRAME_BITS, np.int8)
    bits[0:8] = PREAMBLE_BITS
    bits[30:47] = _uint_to_bits(tow_count_next % (1 << 17), 17)
    bits[49:52] = _uint_to_bits(subframe_id, 3)
    if subframe_id == 4 and utc is not None:
        encode_utc_page(bits, utc)
    if subframe_id == 4 and iono is not None:
        encode_iono_page(bits, iono)
    if subframe_id in (4, 5) and almanac_page is not None:
        encode_almanac_page(bits, almanac_page)
    if subframe_id in _LAYOUTS:
        for name, slices, scale, signed in _LAYOUTS[subframe_id]:
            value = getattr(eph, name)
            if value is None:
                raise ValueError(f"ephemeris field {name} is unset")
            if name == "week_number":
                raw = (int(value) - 1024) % 1024
            elif name in _INT_FIELDS:
                raw = int(value)
            else:
                value = float(value)
                if name in _ANGLE_FIELDS:
                    value = (value + GPS_PI) % (2.0 * GPS_PI) - GPS_PI
                raw = int(round(value / scale))
                if name in _ANGLE_FIELDS:
                    # semicircles wrap: +pi and -pi share the code point, so
                    # an angle within half an LSB below +pi must wrap to
                    # -2^(n-1) rather than overflow the signed field
                    total_bits = sum(nb for _, nb in slices)
                    half = 1 << (total_bits - 1)
                    raw = (raw + half) % (1 << total_bits) - half
            total = sum(n for _, n in slices)
            field_bits = _int_to_bits(raw, total) if signed else _uint_to_bits(raw, total)
            k = 0
            for start, n in slices:
                bits[start:start + n] = field_bits[k:k + n]
                k += n
    return bits


def build_nav_stream(eph: Ephemeris, first_tow_count: int, n_subframes: int,
                     d29star: int = 0, d30star: int = 0,
                     iono: np.ndarray | None = None,
                     utc: "UtcParams | None" = None,
                     almanac: "dict[int, Almanac] | None" = None) -> np.ndarray:
    """Transmitted nav-bit stream of ``n_subframes`` consecutive subframes.

    Subframe IDs cycle 1..5 with the frame phase implied by
    ``first_tow_count`` (a subframe with Z-count z has ID (z mod 5)+1 for
    z%5 in 0..4 -- i.e. frames start at Z-counts divisible by 5).
    ``almanac``: optional {prn: Almanac} — frame f's subframe 5 carries
    the almanac page f % 25 + 1 (SV = page number, the ICD paging for
    SVs 1-24) when that PRN is in the dict; subframe 4 keeps the
    iono/UTC page.  Returns (n_subframes*300,) int8 of +/-1 transmitted
    chip-level bits (binary 1 -> +1), ready for the signal synthesizer's
    ``nav_bits``.
    """
    words = []
    for k in range(n_subframes):
        z = first_tow_count + k
        sf_id = z % 5 + 1
        alm_page = None
        if almanac is not None and sf_id == 5:
            page = (z // 5) % 25 + 1
            alm_page = almanac.get(page) if page <= 24 else None
        src = encode_subframe_source(sf_id, (z + 1) % (1 << 17), eph,
                                     iono=iono, utc=utc,
                                     almanac_page=alm_page)
        words.append(src.reshape(_WORDS, 30)[:, :24])
    source_words = np.concatenate(words, axis=0)
    tx01 = encode_stream(source_words, d29star, d30star)
    return (2 * tx01.astype(np.int8) - 1)


def _corrected_words(bits, d30star, n_words: int) -> np.ndarray:
    """(n_words, 30) 0/1 data words after per-word polarity correction
    (reference checkPhase, ephemeris.py:30-56): accepts +/-1 or 0/1 input,
    un-XORs each word's 24 data bits where the previous word's D30 is 1."""
    bits = np.asarray(bits)
    if bits.shape[0] < n_words * 30:
        raise ValueError(f"need {n_words * 30} bits, got {bits.shape[0]}")
    bits = bits[:n_words * 30]
    if np.any(bits < 0) or np.any(bits > 1):
        bits = (bits > 0).astype(np.int8)   # +/-1 -> 0/1
    else:
        bits = bits.astype(np.int8)
    words = bits.reshape(n_words, 30).copy()
    d30 = np.empty(n_words, np.int8)
    d30[0] = 1 if d30star > 0 else 0
    d30[1:] = words[:-1, 29]
    words[:, :24] ^= d30[:, None]          # un-XOR data bits where D30* == 1
    return words


def decode_ephemeris(bits, d30star) -> tuple[Ephemeris, float]:
    """Decode 5 subframes (1500 bits) into an Ephemeris + TOW.

    ``bits``: 1500 values, either 0/1 or +/-1 (+1 == binary 1), first
    element the first bit of a subframe; ``d30star``: the preceding bit.
    Math identical to reference ephemeris.py:60-190 (with the two ICD
    slice corrections in the module docstring); implementation is
    vectorized array ops instead of per-character string editing.
    """
    source = _corrected_words(bits, d30star, 50).reshape(5, _SUBFRAME_BITS)

    eph = Ephemeris()
    tow_field = None
    for sf in range(5):
        subframe = source[sf]
        sf_id = _bits_to_uint(subframe[49:52])
        if sf_id in _LAYOUTS:
            for name, slices, scale, signed in _LAYOUTS[sf_id]:
                raw_bits = np.concatenate([subframe[s:s + n] for s, n in slices])
                raw = _bits_to_int(raw_bits) if signed else _bits_to_uint(raw_bits)
                if name == "week_number":
                    setattr(eph, name, raw + 1024)
                elif name in _INT_FIELDS:
                    setattr(eph, name, raw)
                else:
                    setattr(eph, name, raw * scale)
        tow_field = _bits_to_uint(subframe[30:47])

    # TOW of the first subframe: the last subframe's HOW holds the Z-count
    # of the sixth subframe (reference: ephemeris.py:190)
    tow = tow_field * _SECONDS_PER_SUBFRAME - 30
    return eph, float(tow)


#: subframe 4 page 18 (ionosphere/UTC page): (field index, bit start,
#: scale) for the 8 Klobuchar coefficients, all 8-bit two's complement
#: (IS-GPS-200 20.3.3.5.1, figure 20-1 sheet 8).  Word 3 data: data ID
#: (2) + SV/page ID 56 (6) + alpha0 + alpha1; word 4: alpha2 alpha3
#: beta0; word 5: beta1 beta2 beta3.
_IONO_FIELDS = [
    (0, 68, 2.0**-30), (1, 76, 2.0**-27),                  # alpha0, alpha1
    (2, 90, 2.0**-24), (3, 98, 2.0**-24), (4, 106, 2.0**11),  # a2 a3 b0
    (5, 120, 2.0**14), (6, 128, 2.0**16), (7, 136, 2.0**16),  # b1 b2 b3
]
_IONO_PAGE_ID = 56


def encode_iono_page(bits: np.ndarray, iono: np.ndarray) -> None:
    """Fill a subframe-4 source-bit array with the page-18 ionospheric
    coefficients (inverse of :func:`decode_iono`)."""
    bits[60:62] = _uint_to_bits(1, 2)                      # data ID
    bits[62:68] = _uint_to_bits(_IONO_PAGE_ID, 6)
    for k, start, scale in _IONO_FIELDS:
        bits[start:start + 8] = _int_to_bits(int(round(float(iono[k]) / scale)), 8)


@dataclass
class UtcParams:
    """GPS-UTC conversion parameters from subframe 4 page 18 words 6-10
    (IS-GPS-200 20.3.3.5.1.6; the reference discards subframes 4-5,
    ephemeris.py:88-91)."""

    a0: float = 0.0            # s, bias at reference time
    a1: float = 0.0            # s/s, drift
    t_ot: float = 0.0          # s, reference time of week
    wn_t: int = 0              # reference week (mod 256)
    delta_t_ls: int = 18       # s, current leap seconds
    wn_lsf: int = 0            # week of next/most-recent leap event (mod 256)
    dn: int = 1                # day of that week, 1..7
    delta_t_lsf: int = 18      # s, leap seconds after the event

    def gps_to_utc_offset(self, tow: float, week_number: int) -> float:
        """GPS-minus-UTC offset (s) at GPS time (week, tow):
        delta_t_UTC = delta_t_LS + A0 + A1 (t - t_ot + 604800 (WN - WN_t))
        (IS-GPS-200 20.3.3.5.2.4).  The leap-second field switches to
        delta_t_LSF once (WN_LSF, DN) is in the past — both weeks compare
        mod 256, as broadcast."""
        wn8 = week_number % 256
        dw = ((wn8 - self.wn_t + 128) % 256) - 128
        offset = self.a0 + self.a1 * (tow - self.t_ot + 604800.0 * dw)
        dw_lsf = ((wn8 - self.wn_lsf + 128) % 256) - 128
        past_event = dw_lsf > 0 or (dw_lsf == 0 and tow >= self.dn * 86400.0)
        leap = self.delta_t_lsf if past_event else self.delta_t_ls
        return leap + offset


#: page 18 words 6-10: UTC fields as (name, bit starts+lengths, scale,
#: signed).  A0 spans the word 7/8 boundary (24 MSBs + 8 LSBs)
_UTC_FIELDS = [
    ("a1", [(150, 24)], 2.0**-50, True),
    ("a0", [(180, 24), (210, 8)], 2.0**-30, True),
    ("t_ot", [(218, 8)], 2.0**12, False),
    ("wn_t", [(226, 8)], 1.0, False),
    ("delta_t_ls", [(240, 8)], 1.0, True),
    ("wn_lsf", [(248, 8)], 1.0, False),
    ("dn", [(256, 8)], 1.0, False),
    ("delta_t_lsf", [(270, 8)], 1.0, True),
]


def encode_utc_page(bits: np.ndarray, utc: UtcParams) -> None:
    """Fill a subframe-4 source-bit array with the page-18 UTC parameters
    (inverse of :func:`decode_utc`; shares the page with the Klobuchar
    coefficients)."""
    bits[60:62] = _uint_to_bits(1, 2)                      # data ID
    bits[62:68] = _uint_to_bits(_IONO_PAGE_ID, 6)
    for name, slices, scale, signed in _UTC_FIELDS:
        raw = int(round(float(getattr(utc, name)) / scale))
        total = sum(n for _, n in slices)
        field = _int_to_bits(raw, total) if signed else _uint_to_bits(raw, total)
        k = 0
        for start, n in slices:
            bits[start:start + n] = field[k:k + n]
            k += n


def decode_utc(bits, d30star) -> UtcParams | None:
    """UTC parameters from a 5-subframe window, or None if no subframe-4
    page 18 is present.  Same conventions as :func:`decode_iono`."""
    source = _corrected_words(bits, d30star, 50).reshape(5, _SUBFRAME_BITS)
    for sf in range(5):
        subframe = source[sf]
        if _bits_to_uint(subframe[49:52]) != 4:
            continue
        if _bits_to_uint(subframe[62:68]) != _IONO_PAGE_ID:
            continue
        utc = UtcParams()
        for name, slices, scale, signed in _UTC_FIELDS:
            raw_bits = np.concatenate([subframe[s:s + n] for s, n in slices])
            raw = _bits_to_int(raw_bits) if signed else _bits_to_uint(raw_bits)
            value = raw * scale
            setattr(utc, name, value if scale != 1.0 else int(value))
        return utc
    return None


def decode_iono(bits, d30star) -> np.ndarray | None:
    """Klobuchar coefficients (8,) [alpha0..3, beta0..3] from a 5-subframe
    window, or None if no subframe-4 page 18 is present.

    Same window/polarity conventions as :func:`decode_ephemeris` (the
    reference discards subframes 4-5 entirely, ephemeris.py:88-91)."""
    source = _corrected_words(bits, d30star, 50).reshape(5, _SUBFRAME_BITS)
    for sf in range(5):
        subframe = source[sf]
        if _bits_to_uint(subframe[49:52]) != 4:
            continue
        if _bits_to_uint(subframe[62:68]) != _IONO_PAGE_ID:
            continue
        out = np.empty(8)
        for k, start, scale in _IONO_FIELDS:
            out[k] = _bits_to_int(subframe[start:start + 8]) * scale
        return out
    return None


@dataclass
class Almanac:
    """One satellite's almanac (subframe 4/5 page, IS-GPS-200 20.3.3.5.1.2).

    Reduced-precision long-term orbit + clock: the reference discards
    subframes 4-5 entirely (ephemeris.py:88-91); here almanac pages are
    encoded into the synthesized stream, collected from tracked captures,
    and usable for acquisition assistance via :func:`almanac_to_ephemeris`
    + nav.assist.predict_doppler.
    """

    prn: int
    e: float            # eccentricity (x 2^-21)
    t_oa: float         # almanac reference time, s (x 2^12)
    delta_i: float      # inclination offset from 0.30 semicircles, rad
    omega_dot: float    # rad/s
    health: int
    sqrt_a: float       # m^0.5 (x 2^-11)
    omega_0: float      # rad
    omega: float        # rad
    m_0: float          # rad
    a_f0: float         # s (x 2^-20, 11 bits split 8+3)
    a_f1: float         # s/s (x 2^-38)


#: almanac page source-bit layout: (field, [(start, nbits), ...], scale,
#: signed); angles in semicircles (x GPS_PI on decode), per IS-GPS-200
#: Table 20-VI (words 3-10 of a subframe 4/5 almanac page)
_ALMANAC_LAYOUT = [
    ("e", [(68, 16)], 2.0**-21, False),
    ("t_oa", [(90, 8)], 2.0**12, False),
    ("delta_i", [(98, 16)], 2.0**-19, True),
    ("omega_dot", [(120, 16)], 2.0**-38, True),
    ("health", [(136, 8)], 1.0, False),
    ("sqrt_a", [(150, 24)], 2.0**-11, False),
    ("omega_0", [(180, 24)], 2.0**-23, True),
    ("omega", [(210, 24)], 2.0**-23, True),
    ("m_0", [(240, 24)], 2.0**-23, True),
    ("a_f0", [(270, 8), (289, 3)], 2.0**-20, True),
    ("a_f1", [(278, 11)], 2.0**-38, True),
]
_ALMANAC_ANGLES = ("delta_i", "omega_dot", "omega_0", "omega", "m_0")
#: subframe 5 pages 1-24 carry SVs 1-24; subframe 4 pages carry SVs 25-32
#: on pages 2,3,4,5,7,8,9,10 (the SV ID word identifies the satellite)
_SF4_ALMANAC_PAGES = {2: 25, 3: 26, 4: 27, 5: 28, 7: 29, 8: 30, 9: 31, 10: 32}


def encode_almanac_page(bits: np.ndarray, alm: Almanac) -> None:
    """Fill a subframe 4/5 source-bit array with one almanac page
    (inverse of the :func:`decode_almanac_pages` field extraction)."""
    bits[60:62] = _uint_to_bits(1, 2)                  # data ID
    bits[62:68] = _uint_to_bits(alm.prn, 6)            # SV ID
    for name, slices, scale, signed in _ALMANAC_LAYOUT:
        value = getattr(alm, name)
        if name in _ALMANAC_ANGLES:
            value = float(value) / GPS_PI              # rad -> semicircles
        raw = int(round(float(value) / scale))
        total = sum(n for _, n in slices)
        if name in _ALMANAC_ANGLES:
            half = 1 << (total - 1)
            raw = (raw + half) % (1 << total) - half
        field = _int_to_bits(raw, total) if signed else _uint_to_bits(raw, total)
        k = 0
        for start, n in slices:
            bits[start:start + n] = field[k:k + n]
            k += n


def decode_almanac_pages(bits, d30star, d29star=None) -> dict[int, Almanac]:
    """Collect almanac entries from an arbitrary-length tracked bit stream.

    ``bits``: +/-1 (or 0/1) nav bits starting at a subframe boundary, any
    number of whole subframes (one frame carries ONE almanac page each on
    subframes 4 and 5; the full 25-page cycle spans 12.5 minutes, so a
    short capture yields the pages it saw).  Returns {prn: Almanac}.
    """
    from softgnss_tpu_torch.nav.parity import nav_parity_check

    bits = np.asarray(bits)
    n_sub = bits.shape[0] // _SUBFRAME_BITS
    words = _corrected_words(bits, d30star, n_sub * _WORDS)
    # raw (pre-correction) +/-1 stream for the parity check, prefixed
    # with the two preceding bits (D29*, D30*) of the first word
    pm = np.where(bits[:n_sub * _SUBFRAME_BITS] > 0, 1, -1).astype(np.int8)
    d30 = np.int8(1 if d30star > 0 else -1)
    d29 = np.int8(1 if (d29star if d29star is not None else d30star) > 0
                  else -1)
    pm = np.concatenate([[d29, d30], pm])
    out: dict[int, Almanac] = {}
    for s in range(n_sub):
        sub = words[s * _WORDS:(s + 1) * _WORDS].reshape(-1)
        # a corrupted span (e.g. post-lock-loss noise bits) must not seed
        # the almanac: require every word of the subframe to pass the
        # IS-GPS-200 parity check (reference navPartyChk semantics;
        # decode_ephemeris relies on findPreambles having verified its
        # span, but almanac pages come from anywhere in the capture).
        # Word 0 of the stream uses d29star when provided (else d30star
        # stands in — wrong ~half the time, costing at most subframe 0).
        ok = all(
            nav_parity_check(pm[s * _SUBFRAME_BITS + w * 30:
                                s * _SUBFRAME_BITS + w * 30 + 32]) != 0
            for w in range(_WORDS))
        if not ok:
            continue
        sf_id = _bits_to_uint(sub[49:52])
        if sf_id not in (4, 5):
            continue
        data_id = _bits_to_uint(sub[60:62])
        sv_id = _bits_to_uint(sub[62:68])
        if data_id != 1:
            continue
        if sf_id == 5:
            if not 1 <= sv_id <= 24:
                continue
            prn = sv_id
        else:
            if sv_id not in _SF4_ALMANAC_PAGES.values():
                continue
            prn = sv_id
        fields = {}
        for name, slices, scale, signed in _ALMANAC_LAYOUT:
            raw_bits = np.concatenate([sub[a:a + n] for a, n in slices])
            raw = _bits_to_int(raw_bits) if signed else _bits_to_uint(raw_bits)
            value = raw * scale
            if name in _ALMANAC_ANGLES:
                value *= GPS_PI
            fields[name] = value
        fields["health"] = int(fields["health"])
        out[prn] = Almanac(prn=prn, **fields)
    return out


def almanac_to_ephemeris(alm: Almanac, week_number: int = 1024) -> Ephemeris:
    """Reduced-precision Ephemeris from an almanac entry — propagates
    through the same Kepler machinery (nav.orbit) at almanac accuracy
    (km-level positions, good for visibility and Doppler prediction via
    nav.assist.predict_doppler; IS-GPS-200 20.3.3.5.2.3: i_0 = 0.30
    semicircles + delta_i, all correction terms zero)."""
    return Ephemeris(
        week_number=week_number, accuracy=0, health=alm.health,
        t_gd=0.0, iodc=0, t_oc=alm.t_oa,
        a_f2=0.0, a_f1=alm.a_f1, a_f0=alm.a_f0,
        iode_sf2=0, c_rs=0.0, delta_n=0.0, m_0=alm.m_0,
        c_uc=0.0, e=alm.e, c_us=0.0, sqrt_a=alm.sqrt_a, t_oe=alm.t_oa,
        c_ic=0.0, omega_0=alm.omega_0, c_is=0.0,
        i_0=0.30 * GPS_PI + alm.delta_i, c_rc=0.0, omega=alm.omega,
        omega_dot=alm.omega_dot, iode_sf3=0, i_dot=0.0,
    )


def ephemeris_to_almanac(eph: Ephemeris, prn: int) -> Almanac:
    """Reduce a full ephemeris to its almanac representation (the page a
    satellite would broadcast for itself) — the synthesizer's source for
    subframe-5 almanac pages.

    t_oa is quantized to the ICD's 4096 s grid, so the anomaly and node
    are RE-EPOCHED to the quantized time (m_0 by the mean motion,
    omega_0 by omega_dot; the -OMEGA_E_DOT*t_oe term of the node
    equation cancels against the earth-rotation part of the shift) —
    without this the decoded almanac would propagate from a reference
    time up to 2048 s away from the orbital elements' true epoch,
    i.e. thousands of km of along-track error.
    """
    from softgnss_tpu_torch.nav.orbit import GM

    t_oa = float(np.round(float(eph.t_oe) / 4096.0) * 4096.0)
    dt = t_oa - float(eph.t_oe)
    n0 = np.sqrt(GM) / float(eph.sqrt_a) ** 3 + float(eph.delta_n or 0.0)

    def wrap(x):
        return float((x + GPS_PI) % (2.0 * GPS_PI) - GPS_PI)

    return Almanac(
        prn=prn, e=float(eph.e), t_oa=t_oa,
        delta_i=float(eph.i_0) - 0.30 * GPS_PI,
        omega_dot=float(eph.omega_dot), health=int(eph.health or 0),
        sqrt_a=float(eph.sqrt_a),
        omega_0=wrap(float(eph.omega_0) + float(eph.omega_dot) * dt),
        omega=float(eph.omega), m_0=wrap(float(eph.m_0) + n0 * dt),
        a_f0=float(eph.a_f0) + float(eph.a_f1) * dt, a_f1=float(eph.a_f1),
    )


def decode_tow(bits, d30star) -> float:
    """TOW (s) at the START of a subframe from its first 60 bits (TLM+HOW).

    Same polarity correction and HOW Z-count slice as
    :func:`decode_ephemeris`, but needing only one subframe's first two
    words — the warm-start path (externally supplied ephemerides) can
    timestamp measurements 1.2 s after a confirmed preamble instead of
    waiting for the full 30 s frame.  ``bits``: >= 60 values (0/1 or
    +/-1), first element the first TLM bit; ``d30star``: the preceding
    bit.  The HOW holds the Z-count of the NEXT subframe, so this
    subframe starts at (z - 1) * 6 s.
    """
    words = _corrected_words(bits, d30star, 2)
    z = _bits_to_uint(words[1, :17])
    return float(z * _SECONDS_PER_SUBFRAME - _SECONDS_PER_SUBFRAME)


def save_ephemerides(path: str, ephs: list[Ephemeris | None],
                     iono: np.ndarray | None = None,
                     utc: UtcParams | None = None) -> None:
    """Persist a 32-entry per-PRN ephemeris list to .npz (the warm-start
    input; pair with ``run_receiver(ephemerides=load_ephemerides(path))``).
    Missing satellites/fields are NaN.  ``iono``: optional (8,) Klobuchar
    coefficients stored alongside (``load_iono``); ``utc``: optional UTC
    parameters (``load_utc``) — a warm-start run reads no subframe 4, so
    the prior run's page-18 data rides the file."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(Ephemeris)]
    arrays = {}
    for name in names:
        col = np.full(32, np.nan)
        for i, e in enumerate(ephs[:32]):
            if e is not None and getattr(e, name) is not None:
                col[i] = getattr(e, name)
        arrays[name] = col
    if iono is not None:
        arrays["iono_klobuchar"] = np.asarray(iono, np.float64)
    if utc is not None:
        arrays["utc_params"] = np.asarray(
            [getattr(utc, f.name) for f in dataclasses.fields(UtcParams)],
            np.float64)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_ephemerides(path: str) -> list[Ephemeris | None]:
    """Inverse of :func:`save_ephemerides` (ephemeris list part)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    out: list[Ephemeris | None] = []
    for i in range(32):
        eph = Ephemeris()
        any_field = False
        for name in data.files:
            if name in ("iono_klobuchar", "utc_params"):
                continue
            v = data[name][i]
            if np.isfinite(v):
                any_field = True
                setattr(eph, name, int(v) if name in _INT_FIELDS else float(v))
        out.append(eph if any_field else None)
    return out


def load_iono(path: str) -> np.ndarray | None:
    """Klobuchar coefficients stored by :func:`save_ephemerides`, if any."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return data["iono_klobuchar"] if "iono_klobuchar" in data.files else None


def load_utc(path: str) -> UtcParams | None:
    """UTC parameters stored by :func:`save_ephemerides`, if any."""
    import dataclasses

    data = np.load(path if path.endswith(".npz") else path + ".npz")
    if "utc_params" not in data.files:
        return None
    vals = data["utc_params"]
    utc = UtcParams()
    for k, f in enumerate(dataclasses.fields(UtcParams)):
        v = float(vals[k])
        setattr(utc, f.name, v if f.type == "float" else int(v))
    return utc
