"""Per-layer metric readers, one module per metric named in BENCHMARK.json.

Each module gives LAYER (the layer as PERF.md names it), UNIT, MOVES (the
end-to-end metric it should move) and ``read(readings)``, which returns
the number or None where the run holds nothing to read
(``gnss_bench.run.Readings``).
"""
