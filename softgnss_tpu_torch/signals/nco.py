"""Integer numerically-controlled oscillators (NCOs) for carrier and code.

The same exact integer NCOs as softgnss_tpu.signals.nco, on torch tensors:

* **Carrier**: phase in uint32 "turns" (2^32 counts per cycle), held as
  int32 with mod-2^32 wraparound.  Torch has no usable uint32 arithmetic
  and leaves int32 overflow unspecified, so every wrap is done on int64
  masked to 32 bits and then reinterpreted.
* **Code**: chip phase in Q40 fixed point (int64); block sizes and ceil'd
  chip indices are exact integer arithmetic (arithmetic ``>>`` on int64).

Every function here is bit-exact against its JAX counterpart on the same
inputs, on any device: rounding is round-half-to-even (``torch.round``,
as ``jnp.round``), divisions are true divisions on every device, and the
sine polynomial runs in float32 with its coefficients rounded to float32,
one operation at a time.
"""

from __future__ import annotations

import torch

#: carrier phase fractional bits (uint32 turns)
CARRIER_FRAC_BITS = 32
#: code phase fractional bits (Q40 chips in int64)
CODE_FRAC_BITS = 40
#: one chip in Q40
CODE_ONE = 1 << CODE_FRAC_BITS

_TWO32 = float(2**32)
_LOW32 = 0xFFFFFFFF


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor, correctly rounded on every device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead).
    The divisor tensor is filled on the device (``torch.full``): copying
    it from the host would synchronize with the card on every call."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def wrap_u32_to_i32(x64: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor, reinterpreted as int32."""
    low = torch.bitwise_and(x64.to(torch.int64), _LOW32)
    return (low - ((low >> 31) << 32)).to(torch.int32)


def code_step_q(code_freq_hz: torch.Tensor, sampling_freq: float) -> torch.Tensor:
    """Code NCO step in Q40 chips/sample: round(codeFreq/fs * 2^40), int64."""
    return torch.round(true_divide(code_freq_hz.to(torch.float64), sampling_freq)
                       * float(CODE_ONE)).to(torch.int64)


def chips_to_q(chips: float) -> int:
    """Host-side: exact Q40 representation of a chip count."""
    return int(round(chips * CODE_ONE))


def ceil_chip_index(phase_q: torch.Tensor) -> torch.Tensor:
    """ceil(phase / 2^40) via arithmetic shift — exact for any sign."""
    return ((phase_q + (CODE_ONE - 1)) >> CODE_FRAC_BITS).to(torch.int32)


def sin_turns(x: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*x) for float32 x in turns: the minimax polynomial of
    softgnss_tpu.signals.nco.sin_turns, ~4e-6 absolute error."""
    x = x - torch.floor(x + 0.5)                      # [-0.5, 0.5)
    x = torch.where(x > 0.25, 0.5 - x, x)
    x = torch.where(x < -0.25, -0.5 - x, x)
    t2 = x * x
    return x * (6.2831853071795860
                + t2 * (-41.341702240399755
                        + t2 * (81.60524927607504
                                + t2 * (-76.70585975306136
                                        + t2 * 42.05869394489765))))


def carrier_turns(phase0_i32, step_i32, k_i32) -> torch.Tensor:
    """Carrier NCO phase (p0 + w*k mod 2^32) at sample offsets ``k``, in
    turns [0, 1), float32, from the top 23 NCO bits as an f32 mantissa."""
    counts = torch.bitwise_and(
        phase0_i32.to(torch.int64) + step_i32.to(torch.int64) * k_i32.to(torch.int64),
        _LOW32)
    mant = ((counts >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def carrier_sin_cos(phase0_i32, step_i32, k_i32):
    """(sin, cos) of the carrier NCO phase at sample offsets ``k``."""
    turns = carrier_turns(phase0_i32, step_i32, k_i32)
    return sin_turns(turns), sin_turns(turns + 0.25)


def carrier_step_u32(freq_hz, sampling_freq: float) -> torch.Tensor:
    """Carrier NCO step: round(f/fs * 2^32) reduced to int32 wraparound counts."""
    f = torch.as_tensor(freq_hz, dtype=torch.float64)
    return wrap_u32_to_i32(torch.round(true_divide(f, sampling_freq) * _TWO32).to(torch.int64))
