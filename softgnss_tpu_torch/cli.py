"""Command-line entry point: ``python -m softgnss_tpu_torch.cli``.

The port of softgnss_tpu.cli: the banner, the data probe and the full
receiver run, with every ReceiverConfig field overridable by ``--set
key=value`` (the JAX CLI's grammar) and a ``--synthetic`` mode that builds
the golden scenario, synthesizes it on the run's device and reports the
3D error against the injected truth.  The run is on the CUDA card; it
raises without one unless ``--cpu`` asks for the host.  ``--stream``
tracks in pipelined time chunks from host memory (a synthesized capture
is first brought into pinned host memory, so that its upload is what
streams).  ``--mesh TIMExCHANNEL`` distributes the run over a
``torch.distributed`` world, one process per rank, with ``--shard``
choosing how tracking shards; every rank runs the chain and rank 0 alone
prints::

    torchrun --standalone --nproc-per-node 2 -m softgnss_tpu_torch.cli \
        --synthetic --fast --cpu --mesh 1x2

A ``1x1`` mesh needs no launcher.  ``--stream`` is single-device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import logging
import sys

import numpy as np
import torch
import torch.distributed as dist

import softgnss_tpu_torch
from softgnss_tpu_torch.config import ReceiverConfig, default_config, fast_config
from softgnss_tpu_torch.device import resolve

BANNER = rf"""
softgnss_tpu_torch v{softgnss_tpu_torch.__version__} — GPS L1 C/A software receiver
  PyTorch + hand-written CUDA kernels: batched FFT acquisition, block DLL/PLL
  tracking, nav decode, least-squares or EKF PVT.
"""

_FIELDS = frozenset(f.name for f in dataclasses.fields(ReceiverConfig))


def _parse_value(raw: str):
    if "," in raw:
        return tuple(_parse_value(v) for v in raw.split(",") if v != "")
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    return raw


def build_config(args) -> ReceiverConfig:
    """The run's config: the preset (``--fast`` or the reference default)
    with ``--set`` overrides, ``--file`` and ``--ms``."""
    cfg = fast_config() if args.fast else default_config()
    overrides = {}
    for item in args.set or []:
        if "=" not in item:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        key, raw = item.split("=", 1)
        if key not in _FIELDS:
            raise SystemExit(f"unknown config field {key!r}")
        overrides[key] = _parse_value(raw)
    if args.file:
        overrides["file_name"] = args.file
    if args.ms is not None:
        overrides["ms_to_process"] = args.ms
    return cfg.with_options(**overrides)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="softgnss_tpu_torch",
        description="GPS L1 C/A software receiver on PyTorch and CUDA")
    parser.add_argument("--file", help="raw IF capture file")
    parser.add_argument("--synthetic", action="store_true",
                        help="run the built-in synthetic golden scenario")
    parser.add_argument("--fast", action="store_true",
                        help="start from the small fast_config instead of the "
                             "reference-parity default_config")
    parser.add_argument("--ms", type=int, help="milliseconds to process")
    parser.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="override any ReceiverConfig field")
    parser.add_argument("--probe", action="store_true", help="run the data-quality probe")
    parser.add_argument("--probe-only", action="store_true",
                        help="probe the capture and exit")
    parser.add_argument("--no-nav", action="store_true", help="skip the navigation stage")
    parser.add_argument("--plot", action="store_true",
                        help="render acquisition/tracking/navigation dashboards (matplotlib)")
    parser.add_argument("--plot-dir", default=".", help="directory for saved plots")
    parser.add_argument("--checkpoint", help="tracking checkpoint .npz path")
    parser.add_argument("--mesh", metavar="TIMExCHANNEL",
                        help="distribute over a mesh of torch.distributed ranks, e.g. "
                             "'1x2' or '2x4' (one process per rank: torchrun)")
    parser.add_argument("--shard", choices=["channel", "time", "time-exact"],
                        default="channel",
                        help="tracking sharding strategy when --mesh is set")
    parser.add_argument("--stream", action="store_true",
                        help="software-pipeline tracking over time chunks "
                             "(capture upload / compute / readback overlap)")
    parser.add_argument("--ephemerides", metavar="NPZ",
                        help="warm start: per-PRN ephemeris set from a previous run "
                             "(--save-ephemerides); navigation then needs ~8-15 s of "
                             "capture instead of 36 s")
    parser.add_argument("--save-ephemerides", metavar="NPZ",
                        help="write the decoded per-PRN ephemeris set after a "
                             "successful navigation run")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU (default: the CUDA card)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def _mesh(parser, args, config):
    """(this rank's device, the mesh) of ``--mesh``; joins the process
    group (torchrun's, or a one-process group)."""
    from softgnss_tpu_torch.parallel import initialize_distributed, make_mesh

    try:
        n_t, n_c = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        parser.error(f"--mesh expects TIMExCHANNEL (e.g. 2x4), got {args.mesh!r}")
    device = initialize_distributed(device="cpu" if args.cpu else None)
    try:
        mesh = make_mesh({config.time_axis: n_t, config.channel_axis: n_c})
    except ValueError as exc:
        parser.error(f"{exc} (hint: torchrun --standalone --nproc-per-node "
                     f"{n_t * n_c} -m softgnss_tpu_torch.cli ...)")
    return device, mesh


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.stream and args.mesh:
        parser.error("--stream is single-device (exclusive with --mesh)")
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    config = build_config(args)
    mesh = None
    if args.mesh:
        device, mesh = _mesh(parser, args, config)
    else:
        device = resolve("cpu" if args.cpu else "cuda")
    if mesh is not None and dist.get_rank() != 0:
        # only rank 0 prints and writes files
        with contextlib.redirect_stdout(io.StringIO()):
            return _run(parser, args, config, device, mesh, writer=False)
    return _run(parser, args, config, device, mesh, writer=True)


def _run(parser, args, config, device, mesh, writer: bool) -> int:
    print(BANNER)
    from softgnss_tpu_torch import io as sio
    from softgnss_tpu_torch.pipeline import run_receiver

    signal = None
    if args.synthetic:
        from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario

        n_ms = config.ms_to_process + config.acquisition_ms + 2
        print(f"Synthesizing golden scenario ({n_ms} ms at "
              f"{config.sampling_freq / 1e6:.3f} Msps on {device})...")
        scenario = build_scenario(config)
        signal = synthesize_scenario(scenario, n_ms, device=device)
        if args.stream and device.type == "cuda":
            # tracking streams the capture up from pinned host memory
            signal = signal.cpu().pin_memory()
        truth = scenario.receiver_ecef
        print(f"  injected receiver ECEF: {truth[0]:.1f} {truth[1]:.1f} {truth[2]:.1f}")
    elif not (args.file or config.file_name):
        parser.error("provide --file, --synthetic, or --set file_name=...")

    if args.probe_only:
        if signal is None:
            signal, config = sio.load_capture(args.file or config.file_name, config)
        head = signal[config.skip_samples: config.skip_samples + 10 * config.samples_per_code]
        head = head.cpu().numpy() if isinstance(head, torch.Tensor) else np.asarray(head)
        stats = sio.probe_data(config, head)
        print(f"Probed {stats['n_samples']} samples: mean {stats['mean']:.3f}, "
              f"std {stats['std']:.2f}, clipped {100 * stats['clipped_fraction']:.2f}%")
        if writer and args.plot:
            from softgnss_tpu_torch import plots

            print(f"Probe plot saved to {plots.plot_probe(config, stats, out_dir=args.plot_dir)}")
        return 0

    ephemerides = iono = utc = None
    if args.ephemerides:
        from softgnss_tpu_torch.nav.message import load_ephemerides, load_iono, load_utc

        ephemerides = load_ephemerides(args.ephemerides)
        iono = load_iono(args.ephemerides)
        utc = load_utc(args.ephemerides)

    results = run_receiver(config, signal=signal, file_name=args.file or None,
                           probe=args.probe, navigate=not args.no_nav,
                           checkpoint=args.checkpoint, stream=args.stream, mesh=mesh,
                           shard=args.shard, ephemerides=ephemerides, iono=iono, utc=utc,
                           device=device)
    print(results.summary())
    if results.has_fix:
        sol = results.solutions
        print(f"Mean ECEF position: {np.nanmean(sol.x):.4f} {np.nanmean(sol.y):.4f} "
              f"{np.nanmean(sol.z):.4f} m")

    if writer and args.save_ephemerides and any(e is not None for e in results.ephemerides):
        from softgnss_tpu_torch.nav.message import save_ephemerides

        save_ephemerides(args.save_ephemerides, results.ephemerides,
                         iono=getattr(results.solutions, "iono", None),
                         utc=getattr(results.solutions, "utc_params", None))
        print(f"Ephemerides saved to {args.save_ephemerides}")

    if args.synthetic and results.has_fix:
        sol = results.solutions
        err = np.sqrt((sol.x - truth[0]) ** 2 + (sol.y - truth[1]) ** 2 + (sol.z - truth[2]) ** 2)
        print(f"3D error vs injected truth: mean {np.nanmean(err):.1f} m, "
              f"max {np.nanmax(err):.1f} m")

    if writer and args.plot:
        from softgnss_tpu_torch import plots

        for path in plots.plot_all(results.config, results, out_dir=args.plot_dir):
            print(f"Plot saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
