"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level module name (``acmil_tpu_torch`` is not ``acmil_tpu``), and the
plain references load nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "acmil_tpu"]

LOAD_ALL = """
import json, os, runpy, sys
sys.path[:0] = [{root!r}, {bench!r}]
runpy.run_path({run!r}, run_name="bench_run")     # defines main, runs nothing
from harness.spec import load_cell, metric_reader, flops
for name in {cells!r}:
    cell = load_cell({root!r}, name)
    kind = cell.kind_module()
    import torch
    from acmil_tpu_torch.engine import train, graphs       # what the kinds drive
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.encoders import build, fast
    for part in cell.config["reference"]:
        cell.reference(part)
    for m in cell.per_layer:
        metric_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCES = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
from harness.spec import load_path
for f in {files!r}:
    load_path(f)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_run_and_every_cell_load_no_jax():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    mods = _top_level_modules(LOAD_ALL.format(
        root=ROOT, bench=BENCH, run=os.path.join(BENCH, "run.py"),
        cells=cells))
    assert "acmil_tpu_torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def _reference_files():
    ref = os.path.join(BENCH, "reference")
    return [os.path.join(ref, f) for f in sorted(os.listdir(ref))
            if f.endswith(".py")]


def test_references_import_nothing_of_the_program():
    files = _reference_files()
    assert files
    mods = _top_level_modules(LOAD_REFERENCES.format(root=ROOT, bench=BENCH,
                                                     files=files))
    assert not mods & {"acmil_tpu_torch", *FORBIDDEN}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in {"acmil_tpu_torch",
                                               *FORBIDDEN}, (path, n)


def test_forbidden_names_are_whole_top_level_names():
    from harness.cli import FORBIDDEN as RUN_FORBIDDEN

    assert sorted(RUN_FORBIDDEN) == sorted(FORBIDDEN)
    assert "acmil_tpu_torch" not in RUN_FORBIDDEN
