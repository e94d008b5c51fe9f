"""A cell of ``BENCHMARK.json`` and the files it names.

The harness knows no cell, configuration, traffic mix or metric by name:
``load_cell`` reads the cell's entry, then

- the configuration from the file its ``configs`` entry names,
- the traffic mix from ``perfbench/traffic/<traffic>.json``,
- the limits of the comparison from ``perfbench/limits/<cell>.json``,
- each metric's reader from ``perfbench/metrics/<metric>.py``,

all under ``root`` (the checkout's root by default), so that a later cell,
configuration or metric is a file added, never a file edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: the keys every metric reader declares, as ``BENCHMARK.json`` gives them
METRIC_KEYS = ("UNIT", "BETTER", "SOURCE")


@dataclasses.dataclass
class Metric:
    name: str
    entry: dict          # its entry in BENCHMARK.json
    module: object       # perfbench/metrics/<name>.py

    def read(self, run) -> object:
        return self.module.read(run)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: pathlib.Path


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(root: pathlib.Path, entry: dict) -> Metric:
    path = root / "perfbench" / "metrics" / f"{entry['name']}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{entry['name'].replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key in METRIC_KEYS:
        want = entry[key.lower()]
        if getattr(module, key) != want:
            raise ValueError(f"metric {entry['name']}: {path.name} declares "
                             f"{key}={getattr(module, key)!r}, "
                             f"BENCHMARK.json {want!r}")
    return Metric(entry["name"], entry, module)


def _reports(entry: dict, cell: str, default: bool) -> bool:
    cells = entry.get("workloads")
    return default if cells is None else cell in cells


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    work = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = read_json(root / conf["file"])
    traffic = read_json(root / "perfbench" / "traffic"
                        / f"{work['traffic']}.json")
    limits = read_json(root / "perfbench" / "limits" / f"{name}.json")
    e2e = [load_metric(root, m) for m in bench["end_to_end"]
           if _reports(m, name, True)]
    moved = {m.name for m in e2e}
    layer = [load_metric(root, m) for m in bench["per_layer"]
             if _reports(m, name, m["moves"] in moved)]
    return Cell(name, int(work["chips"]), config, traffic,
                limits["limits"], e2e, layer, root)
