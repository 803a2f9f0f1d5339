"""A cell as ``BENCHMARK.json`` names it, with the files it is made of.

Everything that belongs to one configuration, traffic mix, kind of
traffic, cell or per-layer metric is a file of its own, found by name:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration;
- ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``kind``
  names
- ``portbench/kinds/<kind>.py``: the shape of that traffic: how an input
  is made, the program's entry point that takes it, the reference that
  answers it and the comparison of the two (see ``kinds/__init__.py``);
- ``portbench/limits/<cell>.json``: the limit of each compared number;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(run)`` that returns a number or None.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent

__all__ = ["Cell", "load", "kind", "reader", "ROOT"]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path
    kind: object = None  # the module portbench/kinds/<mix kind>.py


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def _module(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str, root: Path = ROOT):
    """The module ``portbench/kinds/<name>.py``."""
    return _module(root / "portbench" / "kinds" / f"{name}.py",
                   "portbench_kind_", name)


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits"
                         / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, cell["chips"], config, mix, limits, e2e, layer, root,
                kind(mix["kind"], root))


def reader(cell: Cell, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    return _module(cell.root / "portbench" / "metrics" / f"{metric}.py",
                   "portbench_metric_", metric).read
