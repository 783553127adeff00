#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``PERF.md`` gives them),
in one process on the card, one JSON line a reading:

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1 2 3 \\
        --modes program control half_batch --seconds 1

- ``program``: a run of the cell (a short window) and its compared numbers;
- ``control``: the plain reference one precision below the configuration's
  in the program's place (``kind.control``), against the reference;
- a fault of ``harness/faults.py``: a run of the cell with it planted.

The benchmark's own runs do none of this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program"])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from harness.cli import pin_environment, require_cards

    pin_environment(ROOT)
    from harness.faults import planted
    from harness.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    require_cards(cell.chips)
    import torch

    dev = torch.device("cuda", 0)
    kind = cell.kind_module()
    for mode in args.modes:
        for seed in args.seeds:
            t0 = time.perf_counter()
            line = {"workload": cell.name, "mode": mode, "seed": seed}
            if mode == "control":
                line["numbers"] = kind.control(cell, seed, dev)
            else:
                if mode == "program":
                    run = kind.run(cell, seed, args.seconds, False, dev)
                else:
                    with planted(cell.kind, mode):
                        run = kind.run(cell, seed, args.seconds, False, dev)
                line.update(numbers={k: v["value"]
                                     for k, v in run.checks.items()},
                            correct=run.correct, attempted=run.attempted,
                            end_to_end=run.end_to_end,
                            memory_peak_bytes=run.memory_peak_bytes,
                            detail=run.detail)
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
