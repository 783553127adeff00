#!/usr/bin/env python3
"""Times kernel B6 (``acmil_tpu_torch/csrc/dsmil_pool.cu``) at the class
counts the configs use (C = 2, 3, 4, and 8) and every feature width of
``config.PRETRAIN_DIMS``, beside its plain version, on one card:

    python3 scripts/b6_widths.py [--tree DIR]

``--tree DIR`` takes ``acmil_tpu_torch`` from DIR (another
commit unpacked there with ``git archive``), so that two designs are timed
in one call on the same card: run old, new, new, old. Each line gives the
device time of B6's kernels (the ``__global__`` functions of DIR's
``csrc/dsmil_pool.cu``, from ``torch.profiler`` with the L2 flushed before
each call, as ``chip_smoke._split_ms`` reads it) and one call of the plain
version (CUDA events), at N = 65536, B = 1, fp16 features, every row
valid. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every (D_feat, D_inner) of PRETRAIN_DIMS; C = 8 is the FMA route's most
SHAPES = [(d, q, c) for d, q in ((384, 128), (512, 256), (768, 384),
                                 (1024, 512), (1536, 768))
          for c in (2, 3, 4, 8)]


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose acmil_tpu_torch is timed")
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, tree)
    # the timing helpers of this checkout's chip_smoke.py, whatever the tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from acmil_tpu_torch.ops import dsmil_pool as dp

    if not dp.__file__.startswith(tree):
        raise RuntimeError(f"acmil_tpu_torch came from {dp.__file__}")
    src = open(os.path.join(tree, "acmil_tpu_torch", "csrc",
                            "dsmil_pool.cu")).read()
    kernels = re.findall(
        r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    smi = cs.card()
    print(f"tree {tree}: kernels {', '.join(kernels)} [{smi}]")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for d, q, c in SHAPES:
        x, m, wq, bq, q_max = cs._b6_inputs(gen, 1, 65536, d, q, c,
                                            torch.float16)
        m[:] = True
        call = lambda: dp.fused_dsmil_pool(x, m, wq, bq, q_max)  # noqa: E731
        bag, lg = call()
        rbag, rlg = dp.dsmil_pool_reference(x.float(), m, wq, bq, q_max)
        err = max(float((bag - rbag).abs().max()),
                  float((lg - rlg).abs().max()))
        per = cs._split_ms(kernels, call)
        plain = cs._time_ms(lambda: dp.dsmil_pool_reference(
            x.float(), m, wq, bq, q_max), 10)
        bound = cs._b6_bound(65536, d, q, c, 2)["bound_ms"]
        dev = sum(per.values())
        print(f"D={d} Q={q} C={c}: device {dev:.4f} ms "
              f"({100 * bound / dev:.1f}% of bound {bound:.4f} ms), plain "
              f"{plain:.4f} ms, max_abs_err {err:.2e}: {cs._fmt_split(per)}")
        del x, m, bag, lg, rbag, rlg
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
