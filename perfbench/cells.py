"""Cells, found by name from ``BENCHMARK.json`` and the files beside it.

A cell (``workloads[i]``) names a configuration and a traffic mix. The
harness reads, relative to the directory that holds ``BENCHMARK.json``:

* ``configs[j]["file"]`` of the configuration of that name;
* ``perfbench/traffic/<traffic>.json``: the training job (split sizes,
  batch, targets, the program's ``TPU`` settings, the peak the step's
  utilisation is taken against);
* ``perfbench/limits/<cell>.json``: the limit of each number the check
  compares, with the readings it was set from;
* ``perfbench/metrics/<metric>.py`` of each per-layer metric the cell
  reports: a module with ``read(run, cell) -> float | None``;
* ``perfbench/reference/kinds/<kind>.py`` of the configuration's
  ``model.kind``: its model family's plain reference, a module with
  ``build(model_cfg, precision)``, ``layers(model_cfg, spatial)`` and
  optionally ``init_kind(name, shape)`` (the contract is in
  ``perfbench/reference/common.py``). The benchmark's weights, its
  reference model and its operation counts all come from it.

A configuration of any family, a mix, a cell or a metric is added by
adding files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    def reader(self, metric: str):
        """The ``read(run, cell)`` function of a per-layer metric."""
        return _module(self.root / "perfbench" / "metrics" / f"{metric}.py",
                       f"perfbench_metric_{metric.replace('.', '_')}").read

    def family(self):
        """The reference module of the configuration's ``model.kind``."""
        kind = self.config["model"]["kind"]
        return _module(self.root / "perfbench" / "reference" / "kinds" /
                       f"{kind}.py", f"perfbench_kind_{kind}")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json`` (default: the
    working directory's)."""
    root = Path.cwd() if root is None else Path(root)
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    traffic = _load(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = _load(root / "perfbench" / "limits" / f"{workload}.json")
    return Cell(
        name=workload, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)
