"""Finds a cell's pieces by the names that ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own under the checkout's root:

- a configuration: the ``file`` its entry in ``configs`` names;
- a traffic mix: ``portbench/traffic/<traffic>.json``, run by the driver it
  names, ``portbench/drivers/<driver>.py``;
- a per-layer metric: ``portbench/metrics/<name>.py``, whose ``read(slice)``
  returns its value or None where it finds nothing to read.

A later cell, mix or metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[1]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Optional[Callable] = None  # per-layer metrics: their reader


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, benchmark: Path) -> Cell:
    """The cell named ``workload`` in the benchmark file, with its
    configuration, traffic mix, driver and the metrics it reports."""
    bench = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}; it has {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    driver = _load_module(ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py",
                          f"portbench_driver_{traffic['driver']}")
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [Metric(m["name"], m["unit"],
                    _load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}").read)
             for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, driver, e2e, layer)
