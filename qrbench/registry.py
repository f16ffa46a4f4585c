"""Find a cell's files by the names in ``BENCHMARK.json``.

Every configuration, traffic mix, caller, metric, roofline count and
kernel's record names is a file of its own; a later cell, metric or kernel
is a new file and a new entry, never an edit."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: Dict, workload: str, root: Path = ROOT) -> Tuple[Dict, Dict, Dict]:
    """(the workload's entry, its configuration, its traffic mix)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(by_name)})")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / entry["file"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return w, config, mix


def module(kind: str, name: str) -> ModuleType:
    """``qrbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    importlib.import_module(f"qrbench.{kind}")  # the parent of its relative imports
    spec = importlib.util.spec_from_file_location(
        f"qrbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: Dict, section: str, workload: str):
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``workload`` reports: those without a ``workloads`` list, and those
    whose list names it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def kernels() -> Dict[str, Dict]:
    """Every ``kernels/<kernel>.json``, by name: the program's launch
    counters of the kernel (``counters``) and the parts of the names of
    the profiler's records of its launches (``records``)."""
    return {p.stem: load_json(p) for p in sorted((HERE / "kernels").glob("*.json"))}
