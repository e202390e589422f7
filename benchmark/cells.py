"""Finding a cell's files by the names ``BENCHMARK.json`` gives.

A workload names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); its limits are ``limits/<workload>.json``
and each per-layer metric's reader is ``metrics/<metric>.py``. A later
change adds a cell, a configuration, a mix or a metric by adding such files
and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports ``metric`` (an entry of end_to_end or
        per_layer): every cell its listed cells name, or, without a list,
        every cell that reports the end-to-end metric it moves."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:
            e2e = {m["name"]: m for m in self.end_to_end}
            return metric["moves"] in e2e and self.reports(e2e[metric["moves"]])
        return True


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load(workload: str, root: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (root: the
    checkout this package sits in) with its configuration, traffic and
    limits."""
    root = HERE.parent if root is None else Path(root)
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    config = {**_json(root / configs[w["config"]]["file"]), "name": w["config"]}
    limits_path = bench / "limits" / f"{workload}.json"
    return Cell(
        workload=w,
        config=config,
        traffic={**_json(bench / "traffic" / f"{w['traffic']}.json"), "name": w["traffic"]},
        limits=_json(limits_path)["compared"] if limits_path.exists() else {},
        end_to_end=spec["end_to_end"],
        per_layer=spec["per_layer"],
        root=root,
    )


def metric_reader(name: str, root: Optional[Path] = None):
    """The ``read(ctx)`` of per-layer metric ``name``
    (``benchmark/metrics/<name>.py``; names may hold dots)."""
    root = HERE.parent if root is None else Path(root)
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
