"""The benchmark's capture generator: seeded IF captures, made on the card.

One general generator reads every traffic mix (``traffic/<name>.json``)
and every front end (``configs/<name>.json``).  A mix names how many
distinct captures a run cycles through (``captures``); capture i of
``--seed`` is drawn from the pair (seed, i), capture 0 from the seed
alone.  For each it draws the satellites (distinct PRNs, Dopplers, code
delays, carrier phases, nav bits), then synthesizes the real int8 IF
capture chunk by chunk on the device, noise from a ``torch.Generator``
seeded from the same draw::

    s[k] = A * CA_prn(floor(chips(k)) mod 1023) * D(floor(chips(k) / 20460))
             * sin(2 pi (p0 + w k) / 2^32) + n[k],      n ~ N(0, sigma^2)
    chips(k) = (c0 + step k) / 2^32 chips,   step = round(fc (1 + fd / fL1) / fs 2^32)
    w        = round((IF + fd) / fs 2^32) mod 2^32,    A = sqrt(2 sigma^2 10^(CN0/10) / fs)

so the code and carrier run at exact integer rates, and ``Scene`` holds
the truth the judge holds the receiver to: the code-period boundaries and
the carrier frequency that were synthesized.  Every seed gives the same
sizes (satellites, capture length, channels), so seeds change the numbers
and never the amount of work.  The static-satellite model is the
Doppler-consistent case of softgnss_tpu_torch.signals.synth's signal
model; a job of this benchmark never navigates, so orbits and nav
subframes would change no work the receiver does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gnss_bench.codes import CODE_LENGTH, gold_codes

L1_HZ = 1_575_420_000.0
CHIPS_PER_BIT = CODE_LENGTH * 20
#: nav bits drawn per satellite (41 s of bits; they repeat past that)
N_BITS = 2048
_Q = 32
#: chips added to every code phase so that chips(k) >= 0 (whole bits)
_CHIP_OFFSET = CHIPS_PER_BIT * 64


@dataclass(frozen=True)
class Scene:
    """The satellites of one capture and the integer NCO words that made it."""

    sampling_freq: float
    intermediate_freq: float
    code_freq_basis: float
    n_samples: int
    noise_std: float
    seed: int
    index: int               # which of the run's captures
    noise_seed: int          # the torch.Generator's seed
    prn: np.ndarray          # (S,) int64
    doppler_hz: np.ndarray   # (S,) drawn Doppler
    delay_samples: np.ndarray  # (S,) first code-period start, samples
    amplitude: float
    code_c0: np.ndarray      # (S,) int64 Q32 chips at sample 0
    code_step: np.ndarray    # (S,) int64 Q32 chips per sample
    carr_p0: np.ndarray      # (S,) int64 carrier phase at sample 0, 2^-32 turns
    carr_w: np.ndarray       # (S,) int64 carrier phase per sample, 2^-32 turns
    nav_bits: np.ndarray     # (S, N_BITS) int8 +/-1

    def carrier_hz(self) -> np.ndarray:
        """(S,) the carrier frequency synthesized, Hz."""
        return self.carr_w.astype(np.float64) * self.sampling_freq / 2.0**_Q

    def boundary_offset(self, i: int, sample: np.ndarray) -> np.ndarray:
        """Signed samples from ``sample`` to the nearest code-period start
        of satellite ``i`` (float64)."""
        step = int(self.code_step[i])
        s = np.asarray(sample, np.int64)
        chips_q = int(self.code_c0[i]) + step * s.astype(object)
        period_q = CODE_LENGTH << _Q
        frac = np.array([(c % period_q) for c in np.atleast_1d(chips_q)], dtype=np.float64)
        frac = np.where(frac > period_q / 2, frac - period_q, frac)
        return (-frac / step).reshape(s.shape)


def amplitude_for_cn0(sampling_freq: float, cn0_dbhz: float, noise_std: float) -> float:
    """Amplitude of a real sinusoid at C/N0 = A^2 fs / (2 sigma^2)."""
    return math.sqrt(2.0 * noise_std**2 * 10.0 ** (cn0_dbhz / 10.0) / sampling_freq)


def draw_scene(front_end: dict, traffic: dict, seed: int, index: int = 0) -> Scene:
    """The satellites of capture ``index`` of ``seed`` (host NumPy, cheap)."""
    fs = float(front_end["sampling_freq"])
    f_if = float(front_end["intermediate_freq"])
    fc = float(front_end.get("code_freq_basis", 1_023_000.0))
    spc = int(round(fs / (fc / CODE_LENGTH)))
    n_ms = int(front_end["ms_to_process"]) + int(traffic["capture_extra_ms"])
    n_sats = int(traffic["n_sats"])
    lo, hi = traffic["prn_range"]
    rng = np.random.default_rng(int(seed) if index == 0 else [int(seed), int(index)])
    prn = np.sort(rng.choice(np.arange(lo, hi + 1), size=n_sats, replace=False))
    doppler = rng.uniform(*traffic["doppler_hz"], size=n_sats)
    delay = rng.uniform(0.0, spc, size=n_sats)
    phase = rng.uniform(0.0, 1.0, size=n_sats)
    bits = rng.integers(0, 2, size=(n_sats, N_BITS)).astype(np.int8) * 2 - 1
    noise_seed = int(seed) if index == 0 else int(rng.integers(1 << 62))

    step = np.rint(fc * (1.0 + doppler / L1_HZ) / fs * 2.0**_Q).astype(np.int64)
    c0 = (_CHIP_OFFSET << _Q) - np.rint(delay * step).astype(np.int64)
    w = np.mod(np.rint((f_if + doppler) / fs * 2.0**_Q).astype(np.int64), 1 << _Q)
    p0 = np.mod(np.rint(phase * 2.0**_Q).astype(np.int64), 1 << _Q)
    noise = float(traffic["noise_std"])
    return Scene(
        sampling_freq=fs, intermediate_freq=f_if, code_freq_basis=fc,
        n_samples=n_ms * spc, noise_std=noise, seed=int(seed), index=int(index),
        noise_seed=noise_seed, prn=prn.astype(np.int64),
        doppler_hz=doppler, delay_samples=delay,
        amplitude=amplitude_for_cn0(fs, float(traffic["cn0_dbhz"]), noise),
        code_c0=c0, code_step=step, carr_p0=p0, carr_w=w, nav_bits=bits)


def synthesize(scene: Scene, device, chunk: int = 1 << 23) -> torch.Tensor:
    """The scene's int8 capture, (n_samples,) on ``device``, ``chunk``
    samples at a time."""
    dev = torch.device(device)
    codes = torch.from_numpy(gold_codes()[scene.prn - 1].astype(np.float32)).to(dev)
    bits = torch.from_numpy(scene.nav_bits.astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(scene.noise_seed)
    out = torch.empty(scene.n_samples, dtype=torch.int8, device=dev)
    rad = 2.0 * math.pi / 2.0**_Q
    for k0 in range(0, scene.n_samples, chunk):
        n = min(chunk, scene.n_samples - k0)
        k = torch.arange(k0, k0 + n, dtype=torch.int64, device=dev)
        x = torch.randn(n, generator=gen, device=dev, dtype=torch.float32) * scene.noise_std
        for i in range(len(scene.prn)):
            chips = (int(scene.code_c0[i]) + int(scene.code_step[i]) * k) >> _Q
            val = codes[i].take(torch.remainder(chips, CODE_LENGTH))
            val = val * bits[i].take(torch.remainder(chips // CHIPS_PER_BIT, N_BITS))
            phase = torch.bitwise_and(int(scene.carr_p0[i]) + int(scene.carr_w[i]) * k,
                                      (1 << _Q) - 1)
            x += scene.amplitude * val * torch.sin(phase.to(torch.float32) * rad)
        out[k0:k0 + n] = torch.clamp(torch.round(x), -128, 127).to(torch.int8)
    return out
