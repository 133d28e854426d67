"""The measurement probes of the port, each the counterpart of a TPU
measurement script of ``scripts/`` with the same module name, run on a
CUDA card as ``python -m softgnss_tpu_torch.scripts.<name>``:

* ``pallas_ablate`` (S1) — B4 stage by stage; device, host and in-graph
  time per launch;
* ``mega_vmem_bisect`` (S2) — B1 stage by stage; us per ms of each stage;
* ``builder_time`` (S3) — B2 and its 16-byte variant, L2 cold and warm;
* ``dma_probe`` (S4) — direct, ``cp.async`` and TMA bulk window loads;
* ``pallas_probe`` (S5) — six Hopper constructs against their plain
  versions and a PyTorch call each;
* ``profile_track``, ``mega_sweep`` — the routes' marginal us per ms, and
  the block route's by block size and CTAs per channel;
* ``trace_track``, ``glue_trace`` — a ``torch.profiler`` trace of one
  block-route call, per kernel, per host op and per block;
* ``fullscale_loop`` — the reference closed loop, cold and warm;
* ``warmup_sweep`` — time sharding's warm-up against a sequential run.

Each holds its kernels (or routes) bit-equal to their plain PyTorch
versions (or to each other) before it times them, and prints every number
beside nvidia-smi's card name and power limit.  ``timing`` holds the
shared timers and ``inputs`` the shared synthetic inputs and the
bit-equality check.  S1-S3 launch ablations built into the receiver's
library (``track.cuda_lib.RECEIVER``); S4 and S5 launch the probes' own
(``pallas_probe.PROBE_LIBRARY``), which nothing else loads.
"""
