"""Benchmark of softgnss_tpu_torch, the PyTorch and CUDA receiver, on NVIDIA cards.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m gnss_bench.run --workload ref38.obs --seed 7 --seconds 40 --trace 0

The cells, configurations and metrics are named in ``BENCHMARK.json`` at the
root of the checkout; ``gnss_bench.registry`` finds the files of each by
name (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``).  Everything that judges the program lives here
and imports nothing of it: the capture generator (``generator``), the
plain float64 reference (``reference``), the comparison (``judge``), the
trace reduction (``trace``) and the table of peaks (``roofline``).
"""
