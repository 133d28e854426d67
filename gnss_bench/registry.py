"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

A configuration is the file its ``configs`` entry names, a traffic mix is
``traffic/<name>.json`` and a per-layer metric is ``metrics/<name>.py``,
so a later cell, mix or metric is new files and new entries, never an
edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def benchmark(root: Path | None = None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout (the working directory)."""
    return json.loads(((root or Path.cwd()) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in bench['workloads']]})")


def config(bench: dict, name: str, root: Path | None = None) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads(((root or Path.cwd()) / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metric(name: str):
    """The reader module ``metrics/<name>.py``: LAYER, UNIT, MOVES and read()."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gnss_bench.metrics.{name}", path)
    if spec is None or not path.is_file():
        raise KeyError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
