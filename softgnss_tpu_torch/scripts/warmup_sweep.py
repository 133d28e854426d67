"""Time sharding's warm-up against the divergence of its stitched outputs.

Port of ``scripts/warmup_sweep.py``, the measurement behind the JAX
package's default ``time_shard_warmup_ms`` (VERDICT r1 #6, as the JAX
script cites it: the first review's item on time sharding's warm-up).  The sequential
``run_receiver(..., navigate=False)`` is the truth.  One world of
``n_time x n_channel`` ranks (``parallel.mesh.spawn_world``, gloo; 4 x 2
by default) then tracks the same capture with
``parallel.track_time_sharded`` at each warm-up of :data:`WARMUPS` in
turn, and rank 0 holds each stitched result against the truth
(:func:`warmup_row`) on what navigation reads: nav-bit signs (``i_p``),
sample counters (pseudoranges) and carrier frequency, past the truth's
own pull-in (the first 500 ms); and the warm-up's overhead, the ms that
the ``n_time - 1`` later shards track twice.

Geometry: ``fast_config(number_of_channels=5, ms_to_process=12000,
acq_noncoherent_ms=10)``, 5 satellites of ``build_scenario``, unit
amplitude against noise 1.5 unless a C/N0 is given.

Run on a CUDA card from the repository root (every rank shares it)::

    python -m softgnss_tpu_torch.scripts.warmup_sweep [cn0_dbhz]

Without a CUDA card it raises.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

N_MS = 12_000
N_SATS = 5
N_TIME, N_CHANNEL = 4, 2
WARMUPS = (25, 50, 100, 150, 250, 400, 700, 1000)
SKIP_MS = 500
WORLD_TIMEOUT_S = 900.0
#: the stitched outputs rank 0 writes, when asked, for each warm-up
KEPT = ("absolute_sample", "i_p", "q_p", "carr_freq", "code_freq")


def sweep_config(**kwargs):
    """The JAX script's configuration; ``kwargs`` override it."""
    from softgnss_tpu_torch.config import fast_config

    return fast_config(**{"number_of_channels": N_SATS, "ms_to_process": N_MS,
                          "acq_noncoherent_ms": 10, **kwargs})


def warmup_row(seq, tr, warmup: int, n_ms: int, n_time: int, skip_ms: int = SKIP_MS) -> dict:
    """Time-sharded tracking ``tr`` against the sequential ``seq`` (each with
    ``i_p``, ``absolute_sample`` and ``carr_freq`` of (C, n_ms)) past
    ``skip_ms``: the share of nav-bit signs that differ, in %, the largest
    and the median |absolute_sample| difference, the largest |carr_freq|
    difference in Hz, and the overhead in %: ``(n_time - 1) * warmup`` ms
    re-tracked over ``n_ms``.  (The JAX script wrote ``3 * warmup``: its
    4 shards.)"""
    sl = np.s_[:, skip_ms:]
    bit_err = np.mean(np.sign(tr.i_p[sl]) != np.sign(seq.i_p[sl]))
    das = np.abs(tr.absolute_sample[sl] - seq.absolute_sample[sl])
    df = np.abs(tr.carr_freq[sl] - seq.carr_freq[sl])
    return {"warmup": warmup, "bit_err_pct": 100.0 * float(bit_err),
            "max_das": float(das.max()), "med_das": float(np.median(das)),
            "max_df_hz": float(df.max()), "overhead_pct": 100.0 * (n_time - 1) * warmup / n_ms}


HEADER = (f"{'warmup':>7} {'bit_err%':>9} {'max|dAS|':>9} {'med|dAS|':>9} "
          f"{'max|dF|Hz':>10} {'overhead%':>10} {'track s':>8}")


def format_row(row: dict) -> str:
    return (f"{row['warmup']:>7} {row['bit_err_pct']:>9.4f} {row['max_das']:>9.2f} "
            f"{row['med_das']:>9.3f} {row['max_df_hz']:>10.2f} {row['overhead_pct']:>10.1f} "
            f"{row.get('track_s', float('nan')):>8.3f}")


def _world(data_dir: str, config, channels, warmups, n_time: int, n_channel: int, n_ms: int,
           out_dir: str, keep: bool, device) -> None:
    """One rank: the mesh, then ``track_time_sharded`` at every warm-up; rank
    0 prints and writes the rows (and, with ``keep``, each stitched result);
    every rank writes its kernel launches."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from softgnss_tpu_torch.parallel import receiver_mesh, track_time_sharded
    from softgnss_tpu_torch.track import megakernel as mk
    from softgnss_tpu_torch.track import pallas_kernel as pk

    rank = dist.get_rank()
    dev = (torch.device("cpu") if device is not None and torch.device(device).type == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    wrappers = (mk.build_frames, mk.track_block, mk.track_block_fused, pk.correlate_ms)
    for fn in wrappers:
        fn.launches = 0
    signal = np.load(os.path.join(data_dir, "capture.npy"), mmap_mode="r")
    truth = SimpleNamespace(**np.load(os.path.join(data_dir, "truth.npz")))
    mesh = receiver_mesh(config, n_time=n_time, n_channel=n_channel)
    rows = []
    if rank == 0:
        print(HEADER, flush=True)
    for warmup in warmups:
        t0 = time.perf_counter()
        tr = track_time_sharded(config.with_options(time_shard_warmup_ms=warmup), signal,
                                channels, mesh, n_ms=n_ms, device=dev)
        track_s = time.perf_counter() - t0
        if rank == 0:
            row = {**warmup_row(truth, tr, warmup, n_ms, n_time), "track_s": track_s}
            rows.append(row)
            print(format_row(row), flush=True)
            if keep:
                np.savez(os.path.join(out_dir, f"time_{warmup}.npz"),
                         **{f: getattr(tr, f) for f in KEPT})
    with open(os.path.join(out_dir, f"launches.r{rank}.json"), "w") as f:
        json.dump({fn.__name__: fn.launches for fn in wrappers}, f)
    if rank == 0:
        with open(os.path.join(out_dir, "rows.json"), "w") as f:
            json.dump(rows, f)


def sweep(config, signal, channels, seq, n_ms: int | None = None, n_time: int = N_TIME,
          n_channel: int = N_CHANNEL, warmups=WARMUPS, device=None, out_dir: str | None = None,
          timeout: float = WORLD_TIMEOUT_S) -> tuple[list[dict], list[dict]]:
    """Track ``signal`` (int8, a tensor or NumPy) time-sharded at each of
    ``warmups`` in one spawned world of ``n_time * n_channel`` ranks, each
    computing on ``device`` ("cpu", or its card); ``seq`` is the sequential
    truth (a TrackResults).  The capture goes to the ranks as a file.
    Returns (the rows of :func:`warmup_row` with each warm-up's
    ``track_s`` on rank 0, each rank's kernel launches).  With ``out_dir``,
    rank 0 also writes each warm-up's stitched :data:`KEPT` outputs there
    (``time_<warmup>.npz``)."""
    from softgnss_tpu_torch.parallel.mesh import spawn_world

    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    host = signal.cpu().numpy() if isinstance(signal, torch.Tensor) else np.asarray(signal)
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks read their inputs from files: arguments go down a pipe
        np.save(os.path.join(tmp, "capture.npy"), host)
        np.savez(os.path.join(tmp, "truth.npz"),
                 **{f: getattr(seq, f) for f in ("i_p", "absolute_sample", "carr_freq")})
        keep = out_dir is not None
        out = out_dir if keep else tmp
        os.makedirs(out, exist_ok=True)
        spawn_world(_world, n_time * n_channel,
                    (tmp, config, channels, tuple(warmups), n_time, n_channel, n_ms, out, keep,
                     device), device=device, timeout=timeout)
        with open(os.path.join(out, "rows.json")) as f:
            rows = json.load(f)
        launches = []
        for r in range(n_time * n_channel):
            with open(os.path.join(out, f"launches.r{r}.json")) as f:
                launches.append(json.load(f))
    return rows, launches


def main(argv=None) -> int:
    from softgnss_tpu_torch.pipeline import run_receiver
    from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario
    from softgnss_tpu_torch.scripts.timing import card, require_cuda
    from softgnss_tpu_torch.signals.synth import amplitude_for_cn0

    argv = sys.argv[1:] if argv is None else argv
    cn0 = float(argv[0]) if argv else None
    dev = require_cuda()
    cfg = sweep_config()
    amp = 1.0 if cn0 is None else amplitude_for_cn0(cfg, cn0, 1.5)
    sc = build_scenario(cfg, n_sats=N_SATS, amplitude=amp)
    sig = synthesize_scenario(sc, N_MS + cfg.acquisition_ms + 2, device=dev)
    base = run_receiver(cfg, signal=sig, n_ms=N_MS, navigate=False, device=dev)
    print(f"C/N0 = {cn0 or '~59 (unit amplitude)'} dB-Hz; {N_TIME} x {N_CHANNEL} ranks "
          f"sharing the card [{card()}]", flush=True)
    sweep(cfg, sig, base.channels, base.tracking, n_ms=N_MS, device="cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
