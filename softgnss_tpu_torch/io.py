"""Raw IF sample I/O: capture-file readers and the data probe (host NumPy).

The capture is read once into a contiguous int8 host array (memory-mapped
for int8 files); ``pipeline.run_receiver`` then moves it to the device in
one copy.  Sample encodings (config.data_format):

* ``int8``  - one signed byte per sample (the reference's format)
* ``int16`` - little-endian signed 16-bit, narrowed by ``>> 8``
* ``uint8`` - offset-binary byte (value - 128)
* ``int4``  - two samples per byte, low nibble first, two's complement
* ``int2``  - four samples per byte, LSB-first pairs, {00,01,10,11} -> {+1,+3,-1,-3}
* ``int1``  - eight samples per byte, LSB first, {0,1} -> {+1,-1}
* ``iq8`` / ``iq16`` - interleaved complex I/Q pairs, upconverted by
  :func:`load_capture` to a real stream at fs/4 above the recorded center.

The packed formats, int16 narrowing and the probe's histogram take the
native C++ library (softgnss_tpu_torch.native) where the JAX package's io
does, and its NumPy versions where no compiler is available: the same
bytes either way.
"""

from __future__ import annotations

import numpy as np

from softgnss_tpu_torch import native
from softgnss_tpu_torch.config import ReceiverConfig

_SAMPLES_PER_BYTE = {"int8": 1, "uint8": 1, "int4": 2, "int2": 4, "int1": 8}


def _unpack(raw: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "int8":
        return raw.view(np.int8)
    fast = native.unpack(raw, fmt)
    if fast is not None:
        return fast
    if fmt == "uint8":
        return (raw.astype(np.int16) - 128).astype(np.int8)
    if fmt == "int4":
        lo = (raw & 0x0F).astype(np.int8)
        hi = (raw >> 4).astype(np.int8)
        lo = np.where(lo >= 8, lo - 16, lo).astype(np.int8)
        hi = np.where(hi >= 8, hi - 16, hi).astype(np.int8)
        return np.stack([lo, hi], axis=1).reshape(-1)
    if fmt == "int2":
        table = np.asarray([1, 3, -1, -3], np.int8)
        pairs = np.stack([(raw >> (2 * i)) & 0x3 for i in range(4)], axis=1)
        return table[pairs].reshape(-1)
    if fmt == "int1":
        bits = np.unpackbits(raw[:, None], axis=1, bitorder="little")
        return (1 - 2 * bits.astype(np.int8)).reshape(-1)
    raise ValueError(f"unsupported data_format {fmt!r}")


def _narrow_int16(x: np.ndarray) -> np.ndarray:
    fast = native.narrow_int16(np.ascontiguousarray(x))
    if fast is not None:
        return fast
    return np.clip(np.asarray(x) >> 8, -128, 127).astype(np.int8)


def read_if_samples(path: str, config: ReceiverConfig,
                    count: int | None = None, offset_samples: int = 0) -> np.ndarray:
    """Read IF samples from a capture file as int8.

    ``offset_samples`` skips samples from the file start (initialize.py:94);
    ``count`` limits the number returned (None = rest of file)."""
    fmt = config.data_format
    if fmt == "int16":
        data = np.memmap(path, np.int16, "r", offset=2 * offset_samples)
        if count is not None:
            data = data[:count]
        return _narrow_int16(data)
    if fmt not in _SAMPLES_PER_BYTE:
        raise ValueError(f"unsupported data_format {fmt!r}")
    spb = _SAMPLES_PER_BYTE[fmt]
    byte_offset, rem = divmod(offset_samples, spb)
    raw = np.memmap(path, np.uint8, "r", offset=byte_offset)
    if fmt == "int8" and rem == 0:
        out = raw.view(np.int8)
        return np.asarray(out if count is None else out[:count])
    if count is not None:
        raw = raw[: (rem + count + spb - 1) // spb]
    out = _unpack(np.asarray(raw), fmt)[rem:]
    return out if count is None else out[:count]


def write_if_samples(path: str, samples: np.ndarray) -> None:
    """Write int8 samples to disk (round-trips with data_format='int8')."""
    np.asarray(samples, np.int8).tofile(path)


def upconvert_iq(config: ReceiverConfig, i_samples: np.ndarray,
                 q_samples: np.ndarray):
    """Upconvert a complex I/Q capture to a real IF stream at fs/4: the
    pick pattern [I0, -Q1, -I2, Q3, ...].  Returns (real_int8, config with
    intermediate_freq shifted up by fs/4)."""
    i8 = np.asarray(i_samples, np.int8)
    q8 = np.asarray(q_samples, np.int8)
    n = min(len(i8), len(q8)) // 4 * 4
    out = np.empty(n, np.int8)
    out[0::4] = i8[0:n:4]
    out[1::4] = -np.maximum(q8[1:n:4], -127)      # avoid -(-128) overflow
    out[2::4] = -np.maximum(i8[2:n:4], -127)
    out[3::4] = q8[3:n:4]
    cfg2 = config.with_options(
        intermediate_freq=config.intermediate_freq + config.sampling_freq / 4.0)
    return out, cfg2


def load_capture(path: str, config: ReceiverConfig,
                 count: int | None = None, offset_samples: int = 0):
    """Read a capture of any supported format; returns (signal, config).

    For ``iq8``/``iq16`` the returned config carries the shifted
    ``intermediate_freq`` and ``data_format='int8'`` and governs everything
    downstream; chunked I/Q loads need ``offset_samples`` and ``count`` on
    the 4-sample grid of the fs/4 pick pattern."""
    fmt = config.data_format
    if fmt not in ("iq8", "iq16"):
        return read_if_samples(path, config, count, offset_samples), config
    if offset_samples % 4 or (count is not None and count % 4):
        raise ValueError(
            "I/Q chunked loads need offset_samples and count to be "
            "multiples of 4: the fs/4 upconversion pattern restarts at "
            "phase 0 each call, so off-grid chunks would be mutually "
            f"phase-incoherent (got offset={offset_samples}, count={count})")
    dt = np.int8 if fmt == "iq8" else np.int16
    raw = np.memmap(path, dt, "r", offset=2 * dt().itemsize * offset_samples)
    if count is not None:
        raw = raw[:2 * count]
    raw = np.asarray(raw[: len(raw) // 2 * 2]).reshape(-1, 2)
    if fmt == "iq16":
        i8, q8 = _narrow_int16(raw[:, 0]), _narrow_int16(raw[:, 1])
    else:
        i8, q8 = raw[:, 0].astype(np.int8), raw[:, 1].astype(np.int8)
    signal, cfg2 = upconvert_iq(config, i8, q8)
    return signal, cfg2.with_options(data_format="int8")


def probe_data(config: ReceiverConfig, signal: np.ndarray,
               n_ms: int = 10) -> dict:
    """Quality-check statistics over the first ``n_ms`` of the capture:
    time-series snippet, Welch PSD and amplitude histogram
    (reference: initialize.py:377-414)."""
    n = min(n_ms * config.samples_per_code, len(signal))
    if n < config.samples_per_code:
        raise ValueError(f"probe needs >= 1 ms of samples, got {len(signal)}")
    x = np.asarray(signal[:n], np.float64)

    seg = min(16384, n)
    window = np.hamming(seg)
    step = seg // 2
    n_seg = max(1, (n - seg) // step + 1)
    acc = np.zeros(seg // 2 + 1)
    for i in range(n_seg):
        block = x[i * step: i * step + seg] * window
        acc += np.abs(np.fft.rfft(block)) ** 2
    psd = acc * (1.0 / (config.sampling_freq * np.sum(window**2) * n_seg))
    psd[1:-1] *= 2
    freqs = np.fft.rfftfreq(seg, 1.0 / config.sampling_freq)

    fast = native.probe_stats(np.ascontiguousarray(signal[:n], np.int8))
    if fast is not None:
        nz = fast["hist"].nonzero()[0]
        values, counts = (nz - 128).astype(signal.dtype), fast["hist"][nz]
    else:
        values, counts = np.unique(signal[:n], return_counts=True)
    half = min(n, config.samples_per_code // 2)
    return {
        "n_samples": int(n),
        "time_axis_ms": np.arange(half) / config.sampling_freq * 1000.0,
        "time_series": np.asarray(signal[:half]),
        "psd_freqs_hz": freqs,
        "psd": psd,
        "hist_values": values,
        "hist_counts": counts,
        "mean": float(x.mean()),
        "std": float(x.std()),
        "clipped_fraction": float(np.mean((signal[:n] == 127) | (signal[:n] == -128))),
    }
