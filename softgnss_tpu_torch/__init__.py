"""softgnss_tpu_torch — the GPS L1 C/A software receiver on PyTorch and CUDA.

The port of ``softgnss_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
module for module: capture IO, FFT acquisition, DLL/PLL tracking whose
correlators (and, on the block tracker, loop filters) run in hand-written
CUDA kernels (``track/megakernel.py``, ``track/pallas_kernel.py``,
sources in ``csrc/``), and navigation to a position fix on the host CPU
in float64 (``nav/``).  Every device stage takes an explicit ``device``;
the package imports neither ``jax`` nor ``softgnss_tpu`` and changes no
global dtype setting.
"""

from softgnss_tpu_torch.config import ReceiverConfig, default_config, fast_config  # noqa: F401

__version__ = "0.1.0"


def run_receiver(*args, **kwargs):
    """Convenience re-export of softgnss_tpu_torch.pipeline.run_receiver."""
    from softgnss_tpu_torch.pipeline import run_receiver as _run

    return _run(*args, **kwargs)
