"""Spawned ``gloo`` ranks for the port's multi-process CPU tests.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``;
they meet through a ``file://`` store in a temporary directory, run the
named cases (module-level functions of a test module, which each rank
imports, so that module must import no JAX at module level) on the inputs
the parent saved, and write their results to files. Every process group
has a timeout, and the parent kills ranks that outlive the deadline, so a
collective that deadlocks fails a test instead of hanging.
"""

from __future__ import annotations

import datetime
import importlib
import os
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE = 150          # seconds a group of ranks may take in all
GROUP_TIMEOUT = 60      # seconds any one collective may wait


def _rank_main(rank, world, init_file, inputs_path, out_dir, cases):
    torch.set_num_threads(1)
    # what torchrun would export, for the CLI cases
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), JAX_PLATFORMS="cpu")
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    inp = torch.load(inputs_path, weights_only=False)
    out = {}
    for module, name in cases:
        try:
            out[name] = getattr(importlib.import_module(module), name)(inp)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(world: int, cases, inputs, tmp: str) -> dict:
    """Run ``cases`` (functions taking the inputs) on ``world`` spawned
    ranks, in order; returns each rank's results by case name. Ranks alive
    past ``DEADLINE`` are killed."""
    os.makedirs(tmp, exist_ok=True)
    inputs_path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, inputs_path)
    names = [(fn.__module__, fn.__name__) for fn in cases]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "store"),
                               inputs_path, tmp, names), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    results = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pt")
        results.append(torch.load(path, weights_only=False)
                       if os.path.exists(path) else None)
    return {"ranks": results, "hung": len(hung),
            "codes": [p.exitcode for p in procs]}


def ranks(group: dict, case) -> list:
    """Each rank's result of ``case``, failing on a hung or failed rank."""
    assert not group["hung"], f"{group['hung']} ranks outlived the deadline"
    out = []
    for r, res in enumerate(group["ranks"]):
        assert res is not None, f"rank {r} wrote nothing: {group['codes']}"
        got = res[case.__name__]
        assert not (isinstance(got, dict) and "error" in got), \
            f"rank {r}:\n{got['error']}"
        out.append(got)
    return out
