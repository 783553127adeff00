"""Batch inference: score every slide in a feature file with a trained
checkpoint → per-slide probability CSV (+ metrics when labels exist).

The port of ``scripts/predict.py``::

    python -m acmil_tpu_torch.cli.predict --config config/camelyon_medical_ssl_config.yml \\
        --ckpt ckpt/checkpoint-best.pth --features feats.h5 --out_csv preds.csv \\
        --device cuda

``--ckpt`` is a ``.pth`` file, or a directory holding
``checkpoint-{--tag}.pth``. ``--features`` is the reference's H5 dump or a
torch feature file (``data/ptio.py``). On a CUDA device an ACMIL_GA head
pools each slide through kernel B1; a CLAM head (``clam_sb``, ``clam_mb``)
through B1, and a DSMIL head (``--arch dsmil``, or a checkpoint of one)
through kernel B6, when the slide's padded bag reaches
``models/fast.py::FUSE_MIN_N`` patches, through their plain forwards below.
ACMIL_MHA (``mha``), MHA (``mha_single``), ABMIL and the rest of the
generic zoo (``meanmil``, ``maxmil``, ``lbmil``, ``attmil``,
``attmil_gated``, ``ilra``, ``ips``, ``ibmil``, ``bmil_vis``,
``bmil_enc`` and ``bmil_spvis`` with the slide's coords), ``transmil``, and
MHIM's ``mhim`` and ``pure`` (the student of a ``mhim`` checkpoint) score
through their plain forwards on any device, as the JAX package scores them.

The model's shape comes from the checkpoint's ``MODEL_CONFIG_KEYS``, which
do not hold IBMIL's ``c_path``, MHIM's ``mlp_dim``, ``baseline`` and
``mhim_pad_mode`` or TransMIL's ``transmil_pad_mode``: such a checkpoint
loads only when the ``--config`` YAML repeats them, and raises otherwise
(a pad mode is no shape: a wrap-trained checkpoint scores in zero mode
without one), as ``scripts/predict.py`` of the JAX package does.
"""

from __future__ import annotations

import argparse
import csv
from typing import List, Optional

import numpy as np

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.bags import pad_bag
from acmil_tpu_torch.data.ptio import open_feature_source
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.engine.metrics import classification_metrics
from acmil_tpu_torch.engine.train import make_eval_step
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.utils.device import entry_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("score slides with a trained MIL checkpoint")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint .pth, or a directory of checkpoint-{tag}.pth")
    p.add_argument("--features", required=True, help="feature H5 or .pt file")
    p.add_argument("--out_csv", default="predictions.csv")
    p.add_argument("--arch", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--tag", default="best", choices=["best", "last"])
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; without a card, raises "
                        "unless this is cpu)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Scores every slide; returns ``{"rows": [(name, label, *probs,
    pred)], "metrics": dict | None}``."""
    args = parse_args(argv)
    device = entry_device(args.device)
    conf = Config.from_yaml(args.config, {"arch": args.arch,
                                          "seed": args.seed})
    ckpt = checkpoint.load(checkpoint.checkpoint_path(args.ckpt, args.tag))
    checkpoint.adopt_checkpoint_config(conf, ckpt["config"])

    model, family = build_mil_model(conf)
    model.load_state_dict(ckpt["model"])
    model.to(device)
    eval_step = make_eval_step(model, family)

    src = open_feature_source(args.features)
    rows = []
    try:
        for i, name in enumerate(src.names):
            item = src[i]
            # fp16 on the wire: features are stored fp16, so this is exact
            bag = pad_bag(item["input"], item["coords"], item["label"],
                          min_bucket=conf.min_bucket,
                          max_patches=conf.max_patches, dtype=np.float16)
            if device.type == "cuda":
                bag = bag.pin_memory()
            probs = eval_step(bag.to(device, non_blocking=True))[0]
            probs = probs.cpu().numpy()
            rows.append((name, item["label"], *probs.tolist(),
                         int(probs.argmax())))
    finally:
        src.close()

    with open(args.out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["slide_id", "label"]
                   + [f"prob_{c}" for c in range(conf.n_class)] + ["pred"])
        w.writerows(rows)
    print(f"{len(rows)} slides -> {args.out_csv}")

    metrics = None
    labels = np.asarray([r[1] for r in rows])
    if len(set(labels.tolist())) > 1:
        probs = np.asarray([r[2:2 + conf.n_class] for r in rows])
        metrics = classification_metrics(probs, labels)
        print(f"auc {metrics['auc']:.4f} acc {metrics['acc']:.4f} "
              f"f1 {metrics['f1']:.4f}")
    return {"rows": rows, "metrics": metrics}


if __name__ == "__main__":
    main()
