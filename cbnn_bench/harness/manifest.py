"""Everything a run reads by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration and traffic and each metric;
``cbnn_bench/configs/<config>.json``, ``cbnn_bench/traffic/<traffic>.json``
and ``cbnn_bench/metrics/<metric>.py`` hold them.  A new configuration,
traffic mix or metric is a new file and a new entry: nothing here names
one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "load", "cell", "metrics_for", "load_metric"]

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "cbnn_bench"


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read(root: Path, folder: str, name: str) -> dict:
    with open(Path(root) / PACKAGE / folder / f"{name}.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """(the workload's entry, its configuration, its traffic mix)."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       + ", ".join(sorted(entries)))
    w = entries[workload]
    return w, _read(root, "configs", w["config"]), \
        _read(root, "traffic", w["traffic"])


def metrics_for(bench: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload``
    reports: those that list it, and those with no list."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def load_metric(name: str, root: Path = ROOT):
    """The reader module ``cbnn_bench/metrics/<name>.py``."""
    path = Path(root) / PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
