"""Navigation of a tracking checkpoint by both packages, least squares and
EKF: how far the port's fixes are from the JAX package's and from the
truth.  A script, not a test (pytest does not collect it).

The checkpoint and truth come from a card run::

    python3 chip_smoke.py --save-tracking DIR

then, with DIR copied to a machine with JAX, from the repository root::

    JAX_PLATFORMS=cpu python tests/nav_checkpoint_parity.py DIR

It prints, for each filter, both packages' 3D-error medians (all epochs
and the last third) and the largest difference of their x and dt.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import softgnss_tpu as sg  # noqa: E402
from softgnss_tpu import pipeline as jpipe  # noqa: E402
from softgnss_tpu.nav import solve as jsolve  # noqa: E402
from softgnss_tpu_torch import convert  # noqa: E402
from softgnss_tpu_torch import pipeline as tpipe  # noqa: E402
from softgnss_tpu_torch.nav import solve as tsolve  # noqa: E402


def main(directory: str) -> int:
    d = Path(directory)
    ckpt = str(d / "main_track.npz")
    rx = np.load(d / "main_truth_ecef.npy")
    tr_j, tr_t = jpipe.load_tracking(ckpt), tpipe.load_tracking(ckpt)

    def err(sol):
        return np.sqrt((sol.x - rx[0]) ** 2 + (sol.y - rx[1]) ** 2 + (sol.z - rx[2]) ** 2)

    for nav_filter in ("lsq", "ekf"):
        jcfg = sg.default_config(nav_filter=nav_filter)
        jsol, _ = jsolve.post_navigate(jcfg, tr_j)
        tsol, _ = tsolve.post_navigate(convert.config_from_dict(dataclasses.asdict(jcfg)), tr_t)
        tail = slice(2 * tsol.n_epochs // 3, None)
        print(f"{nav_filter}: {int(np.isfinite(tsol.x).sum())}/{tsol.n_epochs} epochs fixed; "
              f"3D error median port {np.nanmedian(err(tsol)):.6f} m, JAX "
              f"{np.nanmedian(err(jsol)):.6f} m; last third port "
              f"{np.nanmedian(err(tsol)[tail]):.6f} m, JAX {np.nanmedian(err(jsol)[tail]):.6f} m; "
              f"max |x port - x JAX| {np.nanmax(np.abs(tsol.x - jsol.x)):.3e} m, "
              f"max |dt port - dt JAX| {np.nanmax(np.abs(tsol.dt - jsol.dt)):.3e} m")
        if nav_filter == "ekf":
            e = err(tsol)
            print("  EKF 3D error every 6th epoch (port), m: "
                  + " ".join(f"{v:.1f}" for v in e[::6]))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(f"usage: {sys.argv[0]} DIR (written by chip_smoke.py --save-tracking DIR)")
    sys.exit(main(sys.argv[1]))
