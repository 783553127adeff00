"""The command line of ``benchmark/run.py``: one cell, one seed, one run."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "acmil_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_environment(root: str) -> None:
    """Set before torch is imported: every build and kernel cache at a
    fixed path inside the checkout, so that only a cell's first run there
    builds (the port's own ``nvcc`` builds already go to
    ``acmil_tpu_torch/csrc/build/``)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # a library that could load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Modules of JAX or the JAX package this process has loaded, by whole
    top-level name (``acmil_tpu_torch`` is not ``acmil_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(chips: int, memory_peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak)}


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def result_line(cell, run, trace: bool, device: dict) -> dict:
    from harness.common import Context
    from harness.spec import metric_reader
    from harness.trace import breakdown

    out = {"correct": bool(run.correct), "attempted": int(run.attempted),
           "failed": int(run.failed)}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = Context(run.trace, cell, run.work, device["kind"])
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device = dict(device, busy_s=run.trace.busy_s,
                      window_s=run.trace.window_s)
        out["breakdown"] = breakdown(run.trace, run.hosted)
    out["metrics"] = metrics
    out["device"] = device
    out["checks"] = run.checks          # last: each number beside its limit
    return out


def _finite(obj):
    """The line with every non-finite number written as 1e300 (a gap that
    could not be measured reads as the largest), so that it stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv, root: str) -> int:
    args = parse(argv)
    from harness.spec import load_cell

    cell = load_cell(root, args.workload)
    pin_environment(root)
    require_cards(cell.chips)
    import torch

    from harness.common import phase

    torch.cuda.init()
    phase("torch and the card")

    run = cell.kind_module().run(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              f"acmil_tpu_torch alone", file=sys.stderr)
        return 3
    line = result_line(cell, run, bool(args.trace),
                       device_info(cell.chips, run.memory_peak_bytes))
    if run.detail:
        print("detail " + json.dumps(_finite(run.detail)), file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line), allow_nan=False), flush=True)
    return 0
