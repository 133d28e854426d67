"""The float64 NumPy oracle (numpy_rx): the reference's math re-derived
independently of the receiver, for tests, scripts and ``chip_smoke.py``."""

from softgnss_tpu_torch.oracle.numpy_rx import (  # noqa: F401
    oracle_acquire_grid,
    oracle_find_preamble,
    oracle_fine_freq,
    oracle_least_squares,
    oracle_navigate,
    oracle_parity,
    oracle_satpos,
    oracle_track_channel,
)
