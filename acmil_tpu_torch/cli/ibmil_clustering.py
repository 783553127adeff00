"""IBMIL confounder clustering (phase 1.5), the port of
``IBMIL_clustering.py``::

    python -m acmil_tpu_torch.cli.ibmil_clustering \\
        --config config/camelyon_medical_ssl_config.yml --ckpt_dir ckpt \\
        --device cuda

It loads phase 1's ``checkpoint-best.pth`` from ``--ckpt_dir`` (the config's
``ckpt_dir`` when not given), takes the checkpoint config's ``seed``,
``D_feat``, ``D_inner``, ``n_class``, ``pretrain``, ``dataset``,
``min_bucket`` and ``max_patches`` unless the command line sets them (the
seed picks the frozen split, so the train set is the one phase 1 trained
on), collects every train bag's ``bag_feat`` on the device, clusters them
with ``ops/kmeans.py`` (k-means++ from seed 66, 20 Lloyd iterations, on the
device) and saves the centroids as
``{out_dir}/{dataset}/train_bag_cls_agnostic_feats_proto_{k}_pretrain_{pretrain}_seed_{seed}.npy``
(`IBMIL_clustering.py:118-145`).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from acmil_tpu_torch.cli.train import feature_file, load_conf
from acmil_tpu_torch.data import BagLoader, build_hdf5_feat_dataset
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.ops.kmeans import build_confounder_prototypes
from acmil_tpu_torch.utils import set_seed
from acmil_tpu_torch.utils.device import entry_device

# the phase-1 training config the clustering takes from the checkpoint
CLUSTER_KEYS = ("seed", "D_feat", "D_inner", "n_class", "pretrain", "dataset",
                "min_bucket", "max_patches")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("IBMIL confounder clustering (PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=None)  # None: the checkpoint's
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="phase-1 IBMIL checkpoint dir")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--out_dir", type=str, default="datasets_deconf")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; without a card, raises "
                        "unless this is cpu)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Writes the prototypes ``[k, D_inner]``; returns the ``.npy`` path."""
    args = parse_args(argv)
    device = entry_device(args.device)
    conf = load_conf(args)
    conf.arch = "ibmil"
    path = checkpoint.checkpoint_path(conf.ckpt_dir, "best")
    if not os.path.isfile(path):
        raise SystemExit(f"no checkpoint-best under {conf.ckpt_dir}; train "
                         "phase 1 first (cli/step3_ibmil.py)")
    ckpt = checkpoint.load(path)
    checkpoint.adopt_checkpoint_config(conf, ckpt["config"], CLUSTER_KEYS,
                                       cli_args=args)
    set_seed(conf.seed)

    model, _ = build_mil_model(conf)
    model.load_state_dict(ckpt["model"])
    model.to(device).eval()
    print(f"loaded phase-1 checkpoint from {conf.ckpt_dir}")
    train_src, _, _ = build_hdf5_feat_dataset(feature_file(conf), conf)
    loader = BagLoader(train_src, conf.B, min_bucket=conf.min_bucket,
                       max_patches=conf.max_patches, dtype=np.float16,
                       device=device)
    feats = []
    with torch.no_grad():
        for bag in loader:
            f = model(bag.feats, bag.mask, deterministic=True)["bag_feat"]
            feats.append(f[bag.mask.any(dim=1)])
    feats = torch.cat(feats).reshape(-1, conf.D_inner)
    print(f"collected {feats.shape[0]} bag features, clustering k={args.k}")

    protos = build_confounder_prototypes(feats, k=args.k, seed=66,
                                         device=device)
    out_dir = os.path.join(args.out_dir, conf.dataset)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir,
                       f"train_bag_cls_agnostic_feats_proto_{args.k}_pretrain_"
                       f"{conf.pretrain}_seed_{conf.seed}.npy")
    np.save(out, protos)
    print(f"saved confounder prototypes {protos.shape} -> {out}")
    return out


if __name__ == "__main__":
    main()
