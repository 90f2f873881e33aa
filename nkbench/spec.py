"""Finds what ``BENCHMARK.json`` names, by name, in files of its own.

* a configuration ``<c>``: ``nkbench/configs/<c>.json``;
* a traffic mix ``<t>``: ``nkbench/traffic/<t>.json``;
* an end-to-end metric ``<m>``: its reader ``nkbench/e2e/<m>.py``;
* a per-layer metric ``<m>``: its reader ``nkbench/metrics/<m>.py``.

A metric split by the cells it moves (``accept_ms.serve`` beside
``accept_ms``) is read by the reader of the name before its first dot,
unless it has a file of its own.  A reader is a module with
``read(run) -> float | None``: ``None`` where it finds nothing to read,
and the harness then leaves the metric out.  Its unit, layer, cells and
the metric it moves are stated in ``BENCHMARK.json`` alone.  Adding a
configuration, a mix or a metric is adding its file and its entry in
``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KINDS = {"config": ("configs", ".json"), "traffic": ("traffic", ".json"),
         "end_to_end": ("e2e", ".py"), "per_layer": ("metrics", ".py")}


def path_of(kind: str, name: str, root: Path = HERE) -> Path:
    """The file that holds ``name`` of ``kind`` (a key of :data:`KINDS`)."""
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    folder, suffix = KINDS[kind]
    return root / folder / f"{name}{suffix}"


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    path = path_of(kind, name, root)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} (looked for {path})")
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str, root: Path = HERE) -> ModuleType:
    """The reader module of metric ``name``, loaded from its file (see
    the module)."""
    path = path_of(kind, name, root)
    if not path.is_file():
        path = path_of(kind, name.split(".")[0], root)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} metric named {name!r} "
                                f"(looked for {path_of(kind, name, root)} "
                                f"and {path})")
    mod_name = "nkbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json; one of "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_for(bench: dict, section: str, cell: str) -> List[dict]:
    """The entries of ``bench[section]`` that cell ``cell`` reports: those
    without a ``workloads`` key and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]

