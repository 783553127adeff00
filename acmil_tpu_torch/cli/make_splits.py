"""Frozen split JSONs from a feature file, the port of
``scripts/make_splits.py``:

    python -m acmil_tpu_torch.cli.make_splits --features F.pt \\
        --out_dir splits/camelyon --seeds 1 2 3 4 5

Camelyon semantics (`datasets/datasets.py:16-31`): slides whose name
contains 'test' form the test set; the rest split 90/10 train/val, shuffled
by ``random.Random(seed)``, into ``split_{seed}.json``. The feature file is
a torch file (``data/ptio.py``) or the reference's H5, whose ``h5py`` is
imported only then; ``--h5`` names one as the JAX script's option does.
"""

from __future__ import annotations

import argparse
import json
import os
import random

from acmil_tpu_torch.data.h5io import feature_names


def write_splits(names, out_dir: str, seeds=(1, 2, 3, 4, 5),
                 val_frac: float = 0.1, say=print) -> list:
    """Write ``split_{seed}.json`` for each seed; returns their paths."""
    test = sorted(n for n in names if "test" in n)
    train_val = sorted(n for n in names if "test" not in n)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for seed in seeds:
        rng = random.Random(seed)
        tv = list(train_val)
        rng.shuffle(tv)
        n_val = max(1, int(len(tv) * val_frac))
        split = {"train_names": tv[n_val:], "val_names": tv[:n_val],
                 "test_names": test}
        out = os.path.join(out_dir, f"split_{seed}.json")
        with open(out, "w") as fh:
            json.dump(split, fh, indent=1)
        say(f"{out}: {len(split['train_names'])} train / "
            f"{len(split['val_names'])} val / {len(test)} test")
        paths.append(out)
    return paths


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--features", help="feature file: .pt (torch) or H5")
    src.add_argument("--h5", help="feature H5 (group per slide)")
    p.add_argument("--out_dir", default="./splits/camelyon")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    p.add_argument("--val_frac", type=float, default=0.1)
    args = p.parse_args(argv)
    names = feature_names(args.features or args.h5)
    return write_splits(names, args.out_dir, args.seeds, args.val_frac)


if __name__ == "__main__":
    main()
