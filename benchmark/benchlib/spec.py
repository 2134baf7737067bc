"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

- ``configs/<config>.json``: the deployment (``preset``, ``overrides`` of the
  port's ``SLAMConfig``, ``source``, ``assumed``, ``reduced``);
- ``traffic/<traffic>.json``: the traffic mix, read by the driver that its
  ``entry`` names;
- ``checks/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
- ``metrics/<metric>.py``: the reader of one per-layer metric (``read(ctx)``).

A cell, a configuration, a mix or a metric is added by adding its file and
its entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, bench_json: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench_json`` (default: the repository's
    ``BENCHMARK.json``): its configuration's ``file`` relative to
    ``bench_json``'s directory, its traffic and limits from ``bench_dir``.  Raises
    KeyError for an unknown cell or configuration, FileNotFoundError for a
    missing file."""
    bench_json = bench_json or ROOT / "BENCHMARK.json"
    spec = load_json(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf_entry = configs[w["config"]]
    config = load_json(bench_json.parent / conf_entry["file"])
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "checks" / f"{workload}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
        bench_dir=bench_dir)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``metrics/<name>.py`` as a module; its ``read(ctx)`` returns the
    metric's value, or None where the run has nothing to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
