"""Navigation: bit sync, nav-message codec, orbits, geodesy, PVT.

The port of softgnss_tpu.nav on the host CPU in float64, as the JAX
package runs it: the nav-message codec, parity and preamble search are
NumPy; orbits, geodesy, atmosphere and the PVT epoch loop are torch
float64 tensors on the CPU, the EKF filter (nav.ekf) among them.
"""

from softgnss_tpu_torch.nav.ekf import EkfState, ekf_epoch  # noqa: F401
from softgnss_tpu_torch.nav.message import (  # noqa: F401
    Almanac,
    Ephemeris,
    UtcParams,
    build_nav_stream,
    decode_ephemeris,
    decode_iono,
    decode_tow,
    decode_utc,
    load_ephemerides,
    load_iono,
    load_utc,
    save_ephemerides,
)
from softgnss_tpu_torch.nav.solve import NavSolutions, post_navigate  # noqa: F401
