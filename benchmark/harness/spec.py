"""Finds a cell and everything that belongs to it by name.

- ``BENCHMARK.json`` at the checkout's root names the cell, its
  configuration (a file of sizes) and its traffic mix;
- ``benchmark/traffic/<traffic>.json`` holds the mix, whose ``kind`` names
  its driver, ``benchmark/kinds/<kind>.py``;
- ``benchmark/limits/<cell>.json`` holds the limit of each number compared
  with the plain reference;
- ``benchmark/metrics/<metric>.py`` reads one per-layer metric;
- ``benchmark/kernels/<family>.json`` lists one kernel family's names,
  ``benchmark/flops/<name>.py`` counts work from shapes, and
  ``benchmark/peaks.json`` holds the devices' published peaks.

A later cell, mix, metric or kernel family is a new file and a new entry:
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_modules: Dict[str, object] = {}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_path(path: str):
    """The Python file at ``path`` as a module, loaded once per process."""
    path = os.path.abspath(path)
    mod = _modules.get(path)
    if mod is None:
        name = "bench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def bench_file(*parts: str) -> str:
    return os.path.join(BENCH_DIR, *parts)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, read from its files."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def kind_module(self):
        return load_path(bench_file("kinds", f"{self.kind}.py"))

    def reference(self, part: str):
        """The plain reference module the configuration names for ``part``
        (``head`` or ``trunk``)."""
        return load_path(os.path.join(self.root,
                                      self.config["reference"][part]))


def load_cell(root: str, workload: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=conf["name"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(bench_file("traffic", f"{w['traffic']}.json")),
        limits=load_json(bench_file("limits", f"{workload}.json")),
        end_to_end=e2e, per_layer=per_layer, root=root)


def kernel_table(family: str) -> dict:
    return load_json(bench_file("kernels", f"{family}.json"))


def in_family(table: dict, kernel: str) -> bool:
    """True when the kernel name matches one of the table's ``match``
    patterns and none of its ``exclude`` patterns (regular expressions)."""
    return (any(re.search(p, kernel) for p in table["match"])
            and not any(re.search(p, kernel)
                        for p in table.get("exclude", [])))


def flops(name: str):
    return load_path(bench_file("flops", f"{name}.py"))


def metric_reader(name: str):
    return load_path(bench_file("metrics", f"{name}.py"))


def peaks(device_kind: str) -> Optional[dict]:
    """The published peaks of the device named ``device_kind``: the first
    entry of ``peaks.json`` whose key is part of the name."""
    for key, row in load_json(bench_file("peaks.json")).items():
        if key in device_kind:
            return row
    return None
