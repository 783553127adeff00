#!/usr/bin/env python3
"""Runs one cell of the acmil_tpu_torch benchmark once, on the machine it is
started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its limits and its per-layer
metrics are found by name from ``BENCHMARK.json`` at the root of the
checkout (see ``benchmark/README.md``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference, beside its limit.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    # the harness package, then the port (the checkout's root)
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness.cli import main as cli_main

    return cli_main(argv, ROOT)


if __name__ == "__main__":
    sys.exit(main())
