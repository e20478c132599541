"""Finds what ``BENCHMARK.json`` names: a cell, its configuration file, its
traffic mix (``traffic/<mix>.json``), the setup and entry modules those
name (``setups/<solver>.py``, ``entries/<entry>.py``) and each per-layer
metric's reader (``metrics/<metric>.py``). Adding any of them adds files
and entries, and edits none."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _named(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} {name!r}; there are "
                   f"{sorted(i['name'] for i in items)}")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    with open(ROOT / _named(bench["configs"], name, "config")["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def setup(solver: str):
    return importlib.import_module(f"amgbench.setups.{solver}")


def entry(name: str):
    return importlib.import_module(f"amgbench.entries.{name}")


def reader(metric: str):
    return importlib.import_module(f"amgbench.metrics.{metric}").read


def metrics_of(bench: dict, kind: str, cell_name: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, or list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
