"""Cold-start acquisition: batched FFT code-phase/Doppler search.

Searches every PRN over a Doppler grid for code phase and carrier
frequency by FFT circular correlation, then refines the carrier frequency
with a zoom FFT — softgnss_tpu.acquire.search on ``torch.fft``, on the
device the capture lies on.  The (PRN-chunk, Doppler, lag) grid goes
through one batched FFT -> multiply -> IFFT -> |.|^2 per chunk of
``config.acq_prn_chunk`` PRNs (a Python loop over chunks), and the
fine-frequency stage runs batched over the chunk's PRNs.

The correlation keeps the JAX package's power-of-two zero-padded linear
correlation, folded back to circular (:func:`_corr_fft_len`), so the grid
is the JAX one.  Documented divergences from the reference (zoom-FFT fine
frequency; the off-by-one chip labels it fixes) are those of the JAX
package, see its module docstring.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.device import place
from softgnss_tpu_torch.signals.ca import ca_table, gold_codes
from softgnss_tpu_torch.signals.nco import carrier_sin_cos, carrier_step_u32


@dataclass
class AcquisitionResults:
    """Per-PRN acquisition outputs (row i is PRN i+1); ``carr_freq == 0``
    marks a PRN as not acquired (reference: acquisition.py:44-46)."""

    carr_freq: np.ndarray   # (32,) f64, Hz; 0 if not acquired
    code_phase: np.ndarray  # (32,) i64, samples
    peak_metric: np.ndarray  # (32,) f64, first/second peak ratio
    doppler_bin: np.ndarray  # (32,) i64, the peak's index in config.doppler_bin_freqs

    @property
    def acquired(self) -> np.ndarray:
        return self.carr_freq > 0


@dataclass
class Channels:
    """Tracking channel assignments (reference preRun, acquisition.py:259-306)."""

    prn: np.ndarray            # (C,) i64; 0 = idle channel
    acquired_freq: np.ndarray  # (C,) f64
    code_phase: np.ndarray     # (C,) i64
    status: list[str]          # 'T' tracking / '-' idle

    def __len__(self):
        return len(self.prn)


def fine_freq_resolution(config: ReceiverConfig) -> float:
    """Frequency resolution (Hz) of the zoom-FFT fine-frequency search."""
    return (config.sampling_freq / config.acq_fine_decimation) / config.acq_fine_fft


def _corr_fft_len(config: ReceiverConfig) -> int:
    """FFT length of the code-phase correlation: samples_per_code when it
    is a power of two, else a zero-padded linear correlation of length
    >= 2N folded back circularly in :func:`_prn_block`."""
    spc = config.samples_per_code
    if spc & (spc - 1) == 0:
        return spc
    return 1 << int(np.ceil(np.log2(2 * spc)))


def _baseband_ffts(config: ReceiverConfig, long_signal: torch.Tensor):
    """Doppler-mixed FFTs of the K = ``acq_noncoherent_ms`` acquisition
    milliseconds, (K, B, M) complex64, plus the DC-removed signal."""
    spc = config.samples_per_code
    dev = long_signal.device
    k_ms = config.acq_noncoherent_ms
    sig = long_signal.to(torch.float32)
    sig_ms = sig[: k_ms * spc].reshape(k_ms, spc)
    sig0dc = sig - torch.mean(sig)

    # sin(th) + j*cos(th) = j*exp(-j*th); the global j drops under |.|^2
    freqs = torch.tensor(config.doppler_bin_freqs, dtype=torch.float64, device=dev)
    steps = carrier_step_u32(freqs, config.sampling_freq)            # (B,) i32
    k32 = torch.arange(spc, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sin_v, cos_v = carrier_sin_cos(zero, steps[:, None], k32[None, :])
    mixer = torch.complex(cos_v, -sin_v)                             # e^{-j th}
    xs = torch.fft.fft(mixer[None, :, :] * sig_ms[:, None, :], n=_corr_fft_len(config))
    return xs, sig0dc


def _fine_chip_indices(config: ReceiverConfig) -> np.ndarray:
    """Chip index floor(n*ts/tc) mod 1023 of each fine-search sample."""
    fine_n = config.acq_fine_freq_ms * config.samples_per_code
    ts = 1.0 / config.sampling_freq
    tc = 1.0 / config.code_freq_basis
    chip_idx = np.floor(ts * np.arange(fine_n, dtype=np.float64) / tc)
    return np.mod(chip_idx, 1023).astype(np.int64)


def _prn_block(config: ReceiverConfig, xs, sig0dc, code_fd, gold,
               bin_mask=None):
    """Full acquisition math for a block of PRNs.

    ``xs``: (K, B, M) mixed signal FFTs; ``code_fd``: (p, M) conjugated code
    FFTs; ``gold``: (p, 1023) chips; ``bin_mask``: optional (p, B) bool of
    eligible Doppler bins.  Returns (carr_freq or 0, code_phase, metric,
    Doppler bin index)."""
    spc = config.samples_per_code
    fs = config.sampling_freq
    dev = xs.device
    p = code_fd.shape[0]
    fft_n = _corr_fft_len(config)

    def corr_sq(x):
        c = torch.fft.ifft(x[None, :, :] * code_fd[:, None, :])      # (p, B, M)
        if fft_n != spc:
            c = c[..., :spc] + c[..., fft_n - spc:]
        return torch.abs(c) ** 2

    if config.acq_noncoherent_ms == 2:
        # reference scheme: per Doppler row keep the ms with the stronger
        # peak (bit-transition hedge, acquisition.py:129-133)
        r1 = corr_sq(xs[0])
        r2 = corr_sq(xs[1])
        take1 = r1.amax(-1, keepdim=True) > r2.amax(-1, keepdim=True)
        results = torch.where(take1, r1, r2)                         # (p, B, N)
        del r1, r2
    else:
        results = corr_sq(xs[0])
        for k in range(1, config.acq_noncoherent_ms):
            results = results + corr_sq(xs[k])

    # --- peak / second-peak metric (reference: acquisition.py:139-164) ------
    if bin_mask is not None:
        results = torch.where(bin_mask[:, :, None], results, 0.0)
    flat = results.reshape(p, -1)
    peak_idx = torch.argmax(flat, dim=1)
    bin_idx = peak_idx // spc
    code_phase = peak_idx % spc
    peak = flat.gather(1, peak_idx[:, None])[:, 0]

    # exclude [cp - spchip, cp + spchip - 1] circularly in the peak's row
    spchip = config.samples_per_chip
    pos = torch.arange(spc, device=dev)
    delta = (pos[None, :] - code_phase[:, None]) % spc
    keep = (delta >= spchip) & (delta < spc - spchip)
    row = results[torch.arange(p, device=dev), bin_idx]              # (p, N)
    second = torch.where(keep, row, -torch.inf).amax(dim=1)
    metric = peak / second

    # --- fine carrier frequency over 10 ms: zoom FFT -----------------------
    fine_n = config.acq_fine_freq_ms * spc
    decim = config.acq_fine_decimation
    nfft = config.acq_fine_fft
    n_dec = -(-fine_n // decim)
    pad = n_dec * decim - fine_n
    chip_idx = torch.from_numpy(_fine_chip_indices(config)).to(dev)
    freqs_np = np.fft.fftfreq(nfft, 1.0 / (fs / decim))
    band_mask = torch.from_numpy(np.abs(freqs_np) <= config.acq_fine_band_hz).to(dev)
    freqs_fft = torch.from_numpy(freqs_np).to(dev)
    bins = torch.tensor(config.doppler_bin_freqs, dtype=torch.float64, device=dev)
    coarse = bins[bin_idx]

    start = torch.clamp(code_phase, 0, sig0dc.shape[0] - fine_n)
    k = torch.arange(fine_n, device=dev)
    x = sig0dc[start[:, None] + k[None, :]] * gold[:, chip_idx]      # (p, fine_n)
    w = carrier_step_u32(coarse, fs)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sin_v, cos_v = carrier_sin_cos(zero, w[:, None], k.to(torch.int32)[None, :])
    dec_i = torch.nn.functional.pad(x * cos_v, (0, pad)).reshape(p, n_dec, decim).sum(-1)
    dec_q = torch.nn.functional.pad(x * sin_v, (0, pad)).reshape(p, n_dec, decim).sum(-1)
    mag = torch.abs(torch.fft.fft(torch.complex(dec_i, -dec_q), n=nfft))
    kk = torch.argmax(torch.where(band_mask, mag, -torch.inf), dim=1)
    fine_freq = coarse + freqs_fft[kk]

    carr_freq = torch.where(metric > config.acq_threshold, fine_freq, 0.0)
    return carr_freq, code_phase.to(torch.int64), metric.to(torch.float64), bin_idx


def _acquire_device(config: ReceiverConfig, long_signal: torch.Tensor,
                    bin_mask=None, prns=None):
    """(carr_freq, code_phase, metric, Doppler bin) of each PRN of ``prns``
    (``config.acq_satellite_list`` by default), ``config.acq_prn_chunk``
    PRNs per :func:`_prn_block`; ``bin_mask``: (len(prns), B) or None."""
    dev = long_signal.device
    prn_list = np.asarray(config.acq_satellite_list if prns is None else prns, np.int64)
    xs, sig0dc = _baseband_ffts(config, long_signal)
    fft_n = _corr_fft_len(config)
    codes = torch.from_numpy(ca_table(config)[prn_list - 1]).to(dev)   # (P, N)
    code_fd = torch.conj(torch.fft.fft(codes.to(torch.complex64), n=fft_n))
    gold = torch.from_numpy(gold_codes()[prn_list - 1].astype(np.float32)).to(dev)

    chunk = min(config.acq_prn_chunk, len(prn_list))
    outs = []
    for i in range(0, len(prn_list), chunk):
        sl = slice(i, i + chunk)
        outs.append(_prn_block(config, xs, sig0dc, code_fd[sl], gold[sl],
                               None if bin_mask is None else bin_mask[sl]))
    return tuple(torch.cat(o) for o in zip(*outs))


def hint_bin_mask(config: ReceiverConfig, doppler_hints,
                  hint_halfwidth_hz: float) -> np.ndarray | None:
    """(P, B) bool Doppler-bin mask from per-PRN carrier-frequency hints,
    or None when every PRN searches the full band."""
    if doppler_hints is None:
        return None
    hints = np.asarray(doppler_hints, np.float64)
    bins = np.asarray(config.doppler_bin_freqs)
    sel = hints[np.asarray(config.acq_satellite_list) - 1]
    inside = np.abs(bins[None, :] - sel[:, None]) <= hint_halfwidth_hz
    # no hint, or a hint whose window misses the band -> full band
    full = np.isnan(sel) | ~inside.any(axis=1)
    if full.all():
        return None
    return np.where(full[:, None], True, inside)


def acquire(config: ReceiverConfig, long_signal,
            doppler_hints: np.ndarray | None = None,
            hint_halfwidth_hz: float = 500.0, device=None) -> AcquisitionResults:
    """Run acquisition on >= acquisition_ms milliseconds of raw IF samples.

    It runs on ``device``; by default, on the device a tensor lies on, and
    on the card for a NumPy capture (raising without one): pass a CPU
    tensor or ``device="cpu"`` to run on the host.
    ``doppler_hints``: optional (32,) per-PRN predicted absolute carrier
    frequencies (NaN = no hint); hinted PRNs search only Doppler bins
    within ``hint_halfwidth_hz`` of the prediction."""
    long_signal = place(long_signal, device)
    need = config.acquisition_ms * config.samples_per_code
    if long_signal.shape[0] < need:
        raise ValueError(f"acquisition needs {need} samples, got {long_signal.shape[0]}")
    bin_mask = hint_bin_mask(config, doppler_hints, hint_halfwidth_hz)
    if bin_mask is not None:
        bin_mask = torch.from_numpy(bin_mask).to(long_signal.device)
    return per_prn_results(config, [v.cpu().numpy() for v in
                                    _acquire_device(config, long_signal[:need], bin_mask)])


def per_prn_results(config: ReceiverConfig, out) -> AcquisitionResults:
    """AcquisitionResults from (carr_freq, code_phase, metric, Doppler bin)
    arrays in ``config.acq_satellite_list`` order."""
    carr_freq = np.zeros(32)
    code_phase = np.zeros(32, np.int64)
    peak_metric = np.zeros(32)
    doppler_bin = np.zeros(32, np.int64)
    for i, prn in enumerate(config.acq_satellite_list):
        carr_freq[prn - 1] = out[0][i]
        code_phase[prn - 1] = out[1][i]
        peak_metric[prn - 1] = out[2][i]
        doppler_bin[prn - 1] = out[3][i]
    return AcquisitionResults(carr_freq, code_phase, peak_metric, doppler_bin)


def assign_channels(config: ReceiverConfig, acq: AcquisitionResults) -> Channels:
    """Allocate the strongest acquired PRNs to tracking channels
    (reference: acquisition.py:276-305)."""
    c = config.number_of_channels
    prn = np.zeros(c, np.int64)
    freq = np.zeros(c)
    phase = np.zeros(c, np.int64)
    status = ["-"] * c
    order = np.argsort(-acq.peak_metric, kind="stable")
    n_active = min(c, int(acq.acquired.sum()))
    for i in range(n_active):
        p = order[i]
        prn[i] = p + 1
        freq[i] = acq.carr_freq[p]
        phase[i] = acq.code_phase[p]
        status[i] = "T"
    return Channels(prn, freq, phase, status)


def format_channel_status(config: ReceiverConfig, channels: Channels) -> str:
    """ASCII channel table (reference: acquisition.py:308-336)."""
    bar = "*=========*=====*===============*===========*=============*========*"
    lines = [bar,
             "| Channel | PRN |   Frequency   |  Doppler  | Code Offset | Status |",
             bar]
    for i in range(len(channels)):
        if channels.status[i] != "-":
            lines.append("|      %2d | %3d |  %2.5e |   %5.0f   |    %6d   |     %1s  |" % (
                i, channels.prn[i], channels.acquired_freq[i],
                channels.acquired_freq[i] - config.intermediate_freq,
                channels.code_phase[i], channels.status[i]))
        else:
            lines.append("|      %2d | --- |  ------------ |   -----   |    ------   |   Off  |" % i)
    lines.append(bar)
    return "\n".join(lines)
