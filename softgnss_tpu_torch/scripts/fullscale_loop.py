"""The reference workload's closed loop, cold and then warm, on the card.

Port of ``scripts/fullscale_loop.py``: 37 000 ms at fs = 38.192 MHz with
8 channels (the reference's default workload), 8 satellites of
``build_scenario``, synthesized on the card.  ``run_receiver`` runs twice
on the same capture: the first (cold) call pays the first-use costs (the
kernel library's build or load, cuFFT plans, the caching allocator's
first blocks), the second (warm) does not.  Printed, as the JAX script
printed them: the cold run's summary and its ``RESULT`` line (epochs
fixed, median and mean 3D error against the injected position, the
receiver's wall time), then the ``WARM`` line with its wall time and
stage times.  The warm run's tracking is held bit-equal to the cold run's
and its fixes equal; a cold run without a fix raises.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.fullscale_loop

Without a CUDA card it raises.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from softgnss_tpu_torch.pipeline import run_receiver

N_CH = 8
N_MS = 37_000
#: TrackResults fields held bit-equal between the two runs
TRACK_FIELDS = ("absolute_sample", "sample_frac", "code_freq", "carr_freq", "i_p", "i_e",
                "i_l", "q_e", "q_p", "q_l", "dll_discr", "dll_discr_filt", "pll_discr",
                "pll_discr_filt", "lock_loss_ms")


def timed_run(config, signal, n_ms, navigate: bool, device):
    """(results, wall s) of one ``run_receiver`` call."""
    t0 = time.perf_counter()
    res = run_receiver(config, signal=signal, n_ms=n_ms, navigate=navigate, device=device)
    return res, time.perf_counter() - t0


def fix_errors(res, scenario) -> np.ndarray:
    """3D error (m) of every epoch against the scenario's receiver
    position, NaN where the epoch has no fix."""
    sol = res.solutions
    xyz = np.stack([sol.x, sol.y, sol.z], axis=1)
    return np.linalg.norm(xyz - np.asarray(scenario.receiver_ecef)[None, :], axis=1)


def result_line(res, scenario, wall_s: float) -> str:
    err = fix_errors(res, scenario)
    ok = np.isfinite(err)
    return (f"RESULT: {int(ok.sum())}/{len(err)} fixes, median 3D {np.median(err[ok]):.2f} m, "
            f"mean {err[ok].mean():.2f} m; receiver wall {wall_s:.3f} s")


def stage_line(label: str, res, wall_s: float) -> str:
    stages = {k: round(v, 3) for k, v in res.timings_s.items()}
    return f"{label}: wall {wall_s:.3f} s; stages: {stages}"


def assert_same(cold, warm, navigate: bool) -> None:
    """Raise unless the warm run's tracking (every output, the status and
    the final state) is bit-equal to the cold run's and, with navigation,
    its fixes are equal."""
    a, b = warm.tracking, cold.tracking
    for f in TRACK_FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"warm run: {f} differs from the cold run's")
    if a.status != b.status:
        raise AssertionError(f"warm run: status {a.status}, cold {b.status}")
    for f, x, y in zip(a.final_state._fields, a.final_state, b.final_state):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"warm run: final state {f} differs from the cold run's")
    if not navigate:
        return
    if (warm.solutions is None) != (cold.solutions is None):
        raise AssertionError("warm run: one of the two runs has no navigation solution")
    for f in ("x", "y", "z", "tow") if cold.solutions is not None else ():
        if not np.array_equal(getattr(warm.solutions, f), getattr(cold.solutions, f),
                              equal_nan=True):
            raise AssertionError(f"warm run: fixes ({f}) differ from the cold run's")


def fullscale(config, signal, scenario, n_ms: int | None = None, navigate: bool = True,
              cold=None, device=None, report=print) -> dict:
    """``run_receiver`` on ``signal`` cold, then warm, on ``device`` (the
    device ``signal`` lies on by default); ``cold``: the results of an
    earlier call with the same arguments, which then stands for the cold
    run (only the warm one runs here).  Raises when the cold run has no
    fix (with ``navigate``) or the warm run differs from it.  Returns
    ``{"cold": results, "warm": results, "cold_wall_s": s or None,
    "warm_wall_s": s}``."""
    device = signal.device if device is None and isinstance(signal, torch.Tensor) else device
    cold_wall = None
    if cold is None:
        cold, cold_wall = timed_run(config, signal, n_ms, navigate, device)
        if navigate:
            if not cold.has_fix:
                raise AssertionError("cold run: no position fix")
            report(cold.summary())
            report(result_line(cold, scenario, cold_wall))
        report(stage_line("COLD", cold, cold_wall))
    warm, warm_wall = timed_run(config, signal, n_ms, navigate, device)
    assert_same(cold, warm, navigate)
    report(stage_line("WARM", warm, warm_wall) + "; tracking bit-equal to the cold run's"
           + (", fixes equal" if navigate else ""))
    return {"cold": cold, "warm": warm, "cold_wall_s": cold_wall, "warm_wall_s": warm_wall}


def main(argv=None) -> int:
    from softgnss_tpu_torch.config import default_config
    from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    dev = require_cuda()
    cfg = default_config(number_of_channels=N_CH, ms_to_process=N_MS)
    t0 = time.perf_counter()
    sc = build_scenario(cfg, n_sats=N_CH)
    sig = synthesize_scenario(sc, N_MS + cfg.acquisition_ms + 2, device=dev)
    torch.cuda.synchronize()
    print(f"synth {time.perf_counter() - t0:.3f} s, capture {sig.numel() / 1e9:.3f} GB on the "
          f"card [{card()}]", flush=True)
    fullscale(cfg, sig, sc, report=lambda line: print(f"{line} [{card()}]", flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
