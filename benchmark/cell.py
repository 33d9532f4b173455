"""Find a cell and what belongs to it by name: its entry in
``BENCHMARK.json``, its workload file (``workloads/<cell>.json``), its
configuration file (the entry's ``file``), and the reader of each metric
(``metrics/<metric>.py``). Nothing here names a cell, a configuration or a
metric: a new one is new files and new entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json's workloads
    config: dict  # its configuration file
    workload: dict  # its workload file
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or in
    every cell when it lists none."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: dict = None, workloads_dir=None) -> Cell:
    """The cell ``name`` of ``spec`` (BENCHMARK.json at the root by
    default); its workload file from ``workloads_dir`` (``workloads/``)."""
    spec = load_json(ROOT / "BENCHMARK.json") if spec is None else spec
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in spec["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise KeyError(f"cell {name!r} names configuration {entry['config']!r}, not listed")
    config = load_json(ROOT / configs[0]["file"])
    workload = load_json(Path(workloads_dir or HERE / "workloads") / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"cell {name!r}: its workload file says {key} "
                             f"{workload[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(name, entry, config, workload,
                [m for m in spec["end_to_end"] if reports(m, name)],
                [m for m in spec["per_layer"] if reports(m, name)])


def reader(metric: str, metrics_dir=None):
    """The ``read(record) -> number | None`` of ``metrics/<metric>.py``."""
    path = Path(metrics_dir or HERE / "metrics") / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(cell: Cell, record: dict, metrics_dir=None) -> dict:
    """{metric: {"value", "unit"}} of every per-layer metric of the cell
    whose reader finds something to read in ``record``."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], metrics_dir)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
