"""S3: B2, the frames builder, timed with its variants, L2 cold and warm.

Replaces ``scripts/builder_time.py:60`` (``_builder_var``, launched by
``run_var`` at :101-103 and at :144), which timed the TPU frames builder
against variants of its roll width (W = 1024 / 2048 / 4096 words) and
checked each exact against ``build_frames``.  On the H100 no roll exists;
the variants are the access width of ``csrc/build_frames.cu``:

* ``word`` — B2 itself (``build_frames_kernel``): one int32 word per
  thread and access;
* ``vec4`` — ``build_frames_vec4_kernel``: one int4 (16 bytes) per thread
  and access, with a scalar head and tail (a frame starts 4-byte
  aligned only) and the same zero fill at both capture edges.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.builder_time

It holds both variants bit-equal to :func:`megakernel.build_frames_plain`
at ``default_config()``, r = 64, C = 8 and 12, with frames inside the
capture and frames running past both of its ends, and prints each
variant's us per ms and GB/s (bytes read + written) with the L2 flushed
before each call and with the L2 warm, each with nvidia-smi's card line.
Without a CUDA card it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from softgnss_tpu_torch.config import default_config
from softgnss_tpu_torch.scripts.inputs import SEED, assert_bit_equal
from softgnss_tpu_torch.scripts.timing import card, cold_ms, cuda_ms, require_cuda
from softgnss_tpu_torch.track import megakernel as mk

VARIANTS = ("word", "vec4")
R = 64
N_CHANNELS = (8, 12)


def build_frames_vec4(cap_words: torch.Tensor, starts_w: torch.Tensor, r: int, win_w: int,
                      spc_w: int) -> torch.Tensor:
    """:func:`megakernel.build_frames` by 16-byte accesses: kernel
    ``build_frames_vec4_kernel`` (csrc/build_frames.cu) on CUDA tensors,
    whose ``cap_words`` must start 16-byte aligned;
    :func:`megakernel.build_frames_plain` on CPU tensors."""
    if cap_words.device.type == "cpu":
        return mk.build_frames_plain(cap_words, starts_w, r, win_w, spc_w)
    if cap_words.data_ptr() % 16:
        raise ValueError("build_frames_vec4: cap_words must start 16-byte aligned")
    frames = mk._launch_frames("build_frames_vec4", mk.load_library().lib.sg_build_frames_vec4,
                               cap_words, starts_w, r, win_w, spc_w)
    build_frames_vec4.launches += 1
    return frames


build_frames_vec4.launches = 0


def variant(name: str):
    return {"word": mk.build_frames, "vec4": build_frames_vec4}[name]


def frame_args(c: int, r: int, device, edges: bool = False):
    """(cap_words, starts_w, r, win_w, spc_w) at ``default_config()``'s
    geometry over random capture words; ``edges``: channel 0's frames
    start before the capture and channel 1's last frames run past its end."""
    cfg = default_config(number_of_channels=c)
    spc_w, win_w = cfg.samples_per_code // 4, cfg.track_window // 4
    rng = np.random.default_rng(SEED + c)
    n_words = r * spc_w + win_w + 3000
    cap = torch.from_numpy(rng.integers(-2**31, 2**31, n_words).astype(np.int32)).to(device)
    starts = rng.integers(0, 2000, c)
    if edges:
        starts[0] = -7
        starts[1] = n_words - (r - 1) * spc_w - win_w // 2
    return cap, torch.from_numpy(starts.astype(np.int64)).to(device), r, win_w, spc_w


def check(device, n_channels=N_CHANNELS, r: int = R) -> float:
    """Both variants bit-equal to the plain version, inside the capture and
    at both of its edges; raises otherwise.  Returns the largest absolute
    difference (0.0)."""
    worst = 0.0
    for c in n_channels:
        for edges in (False, True):
            args = frame_args(c, r, device, edges)
            want = {"frames": mk.build_frames_plain(*args)}
            for name in VARIANTS:
                worst = max(worst, assert_bit_equal(
                    f"S3 {name} C={c} {'edges' if edges else 'interior'}",
                    {"frames": variant(name)(*args)}, want))
    torch.cuda.synchronize(device)
    return worst


def measure(device, n_channels=N_CHANNELS, r: int = R, n: int = 50) -> dict:
    """Device ms per block of each variant, L2 warm and L2 flushed, the
    plain version's, and the bytes one block moves:
    {C: {variant: {"warm", "cold"}, "plain": ms, "bytes": n}}."""
    res = {}
    for c in n_channels:
        args = frame_args(c, r, device)
        res[c] = {name: {"warm": cuda_ms(lambda v=name: variant(v)(*args), n, busy=True),
                         "cold": cold_ms(lambda v=name: variant(v)(*args), n, device)}
                  for name in VARIANTS}
        res[c]["plain"] = cuda_ms(lambda: mk.build_frames_plain(*args), 10)
        res[c]["bytes"] = 2 * r * c * args[3] * 4
    return res


def report(res: dict, r: int = R) -> None:
    for c, times in res.items():
        for name in VARIANTS:
            for cache in ("cold", "warm"):
                ms = times[name][cache]
                print(f"S3 B2 {name:4s} C={c:2d} r={r} L2 {cache}: {ms * 1e3 / r:7.4f} us/ms, "
                      f"{times['bytes'] / ms / 1e6:8.1f} GB/s ({ms:.4f} ms per block) [{card()}]")
        print(f"S3 B2 plain C={c:2d} r={r}: {times['plain']:.4f} ms per block [{card()}]")


def main() -> int:
    device = require_cuda()
    print(f"worst |kernel - plain| over every variant: {check(device):.1f} (bit-equal)")
    report(measure(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
