"""Step4 — attention heatmaps, the port of
``Step4_visualize_heatmap_camelyon.py``::

    python -m acmil_tpu_torch.cli.step4_heatmap --config config/camelyon_medical_ssl_config.yml \\
        --ckpt_dir ckpt/ --slide_dir slides/ --output_dir heatmaps/ --device cuda

It loads the trained head from ``checkpoint-best.pth`` in ``--ckpt_dir``
(the model's shape from the checkpoint's config), forwards each test slide's
feature bag (``patch_feats_pretrain_{pretrain}.h5``, else ``.pt``, in the
config's ``data_dir``), turns the branch attention into per-patch scores and
renders them over the slide with ``wsi/heatmap.py::vis_heatmap``, one
``{slide}_heatmap.png`` per test slide.

The scores follow the JAX script (`Step4_visualize_heatmap_camelyon.py:76-118`):
attention logits with heads (``[B, H, K, N]``, ACMIL_MHA) are averaged over
heads first, then a masked softmax per branch, the mean over branches, and
the first n valid probabilities times n. CLAM's attention is its output
dict's ``attn`` (one branch for SB, one per class for MB). On a CUDA device
ACMIL_GA, ABMIL and CLAM take their attention from kernel B1
(``models/fast.py::acmil_ga_infer`` / ``abmil_infer`` /
``clam_apply_fused``); every other head, and the CPU, take the plain
forward under its family's calling convention
(``engine/families.py::Family.plain_outputs``). ABMIL's plain forward is
asked for its attention (``return_attn``). IBMIL (either phase) and the
BMIL heads give the ``attn`` of their output dict; the BMIL family gives
its heads the bag's coords (the JAX script passes none, which puts every
patch of a ``bmil_spvis`` bag in one cell of its canvas). A head that
returns bare logits (MHA, meanmil, maxmil, lbmil, attmil, attmil_gated,
ilra, ips, transmil), or a dict without ``attn`` (mhim and pure, whose
attention comes only with ``return_attn``, which the JAX script never asks
for), raises ``model emits no attention``, as the JAX script does. DTFD raises
``DTFD has no per-patch attention``: its attention is per pseudo-bag,
``[B, G, N/G]`` in permuted order, which the JAX script's masked softmax
against the bag's ``[B, 1, N]`` mask cannot broadcast at numGroup > 1 (and
at numGroup 1 would paint in the permuted order).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from acmil_tpu_torch.cli.train import feature_file
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import build_hdf5_feat_dataset
from acmil_tpu_torch.data.bags import Bag, pad_bag
from acmil_tpu_torch.engine import checkpoint, get_family
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.models.acmil import ABMIL, ACMIL_GA
from acmil_tpu_torch.models.dtfd import DTFD
from acmil_tpu_torch.models.fast import (abmil_infer, acmil_ga_infer,
                                         clam_apply_fused, clam_is_fusable)
from acmil_tpu_torch.ops.masked import masked_softmax
from acmil_tpu_torch.utils.device import entry_device
from acmil_tpu_torch.wsi.slide import SLIDE_EXTS, open_slide


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("Step4: attention heatmaps (PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--slide_dir", required=True)
    p.add_argument("--output_dir", default="./heatmaps")
    p.add_argument("--arch", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--patch_size", type=int, default=512)
    p.add_argument("--n_slides", type=int, default=-1)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; without a card, raises "
                        "unless this is cpu)")
    return p.parse_args(argv)


def uses_kernel(model, device: torch.device) -> bool:
    """True where the attention comes from kernel B1."""
    return device.type == "cuda" and (isinstance(model, (ACMIL_GA, ABMIL))
                                      or clam_is_fusable(model))


@torch.no_grad()
def attention_probs(model, bag: Bag, family: str = "default",
                    fused: bool = True) -> torch.Tensor:
    """Per-patch attention ``[B, N]`` of a padded batch: the masked softmax
    of each branch's logits (heads averaged first), averaged over branches.
    ``fused`` takes B1 where :func:`uses_kernel` says so; B1 writes -1e30 at
    pad slots, which the masked softmax never reads. Any other head runs
    its ``family``'s plain forward."""
    if isinstance(model, DTFD):
        raise ValueError("DTFD has no per-patch attention: its attention is "
                         "per pseudo-bag, in the grouping's permuted order "
                         "(the JAX Step4 fails on it at numGroup > 1)")
    model.eval()
    feats, mask = bag.feats, bag.mask
    if fused and uses_kernel(model, feats.device) and clam_is_fusable(model):
        a = clam_apply_fused(model, feats, mask, n_class=0)["attn"]
    elif fused and uses_kernel(model, feats.device):
        infer = acmil_ga_infer if isinstance(model, ACMIL_GA) else abmil_infer
        a = torch.stack([infer(model, f, m)[-1] for f, m in zip(feats, mask)])
    elif isinstance(model, ABMIL):
        a = model(feats, mask, deterministic=True, return_attn=True)[1]
    else:
        out = get_family(family).plain_outputs(model, bag)
        if isinstance(out, tuple):            # acmil, dsmil: (.., .., attn)
            a = out[2]
        elif isinstance(out, dict) and "attn" in out:  # clam, ibmil, bmil
            a = out["attn"]
        else:
            raise ValueError(f"model emits no attention "
                             f"({type(model).__name__})")
    if a.dim() == 4:                          # [B, H, K, N] -> mean heads
        a = a.mean(dim=1)
    return masked_softmax(a, mask[:, None, :]).mean(dim=1)


def find_slide(slide_dir: str, name: str) -> Optional[str]:
    for ext in SLIDE_EXTS:
        cand = os.path.join(slide_dir, name + ext)
        if os.path.exists(cand):
            return cand
    return None


def main(argv: Optional[List[str]] = None) -> dict:
    """Renders every test slide's heatmap; returns ``{"slides": {name:
    {"path", "scores", "shape", "attn_ms", "render_ms"}}, "fused": bool}``
    (``attn_ms``: host wall of the attention, ending in a device sync;
    ``render_ms``: of the rendering and the PNG write)."""
    import cv2

    from acmil_tpu_torch.wsi.heatmap import vis_heatmap

    args = parse_args(argv)
    device = entry_device(args.device)
    conf = Config.from_yaml(args.config, {"arch": args.arch,
                                          "seed": args.seed})
    # the checkpoint's config holds the model shape its weights load into
    ckpt = checkpoint.load(checkpoint.checkpoint_path(args.ckpt_dir, "best"))
    checkpoint.adopt_checkpoint_config(conf, ckpt["config"])
    model, family = build_mil_model(conf)
    model.load_state_dict(ckpt["model"])
    model.to(device).eval()

    _, _, test_src = build_hdf5_feat_dataset(feature_file(conf), conf)
    if len(test_src.names) == 0:
        raise SystemExit(
            f"Step4: the test split is empty — no "
            f"'{conf.split_dir}/{conf.dataset}/split_{conf.seed}.json' was "
            "found and the random-split fallback assigns no test slides. "
            "Pass the --seed used for training so the same frozen split "
            "file is loaded.")

    os.makedirs(args.output_dir, exist_ok=True)
    names = test_src.names[: args.n_slides if args.n_slides > 0 else None]
    out: dict = {"slides": {}, "fused": uses_kernel(model, device)}
    for name in names:
        slide_path = find_slide(args.slide_dir, name)
        if slide_path is None:
            print(f"{name}: slide not found, skipping")
            continue
        item = test_src[test_src.names.index(name)]
        bag = pad_bag(item["input"], item["coords"], item["label"],
                      min_bucket=conf.min_bucket, max_patches=conf.max_patches,
                      dtype=np.float16).to(device)
        t0 = time.perf_counter()
        probs = attention_probs(model, bag, family)[0].cpu().numpy()
        attn_ms = (time.perf_counter() - t0) * 1e3
        n = int(bag.mask.sum())
        # reference scaling: softmax attention x N (Step4:117-118)
        scores = probs[:n] * n

        t0 = time.perf_counter()
        slide = open_slide(slide_path)
        img = vis_heatmap(slide, scores, bag.coords[0, :n].cpu().numpy(),
                          patch_size=(args.patch_size, args.patch_size))
        path = os.path.join(args.output_dir, f"{name}_heatmap.png")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        render_ms = (time.perf_counter() - t0) * 1e3
        print(f"{name}: heatmap -> {path}")
        out["slides"][name] = {"path": path, "scores": scores,
                               "shape": img.shape, "attn_ms": attn_ms,
                               "render_ms": render_ms}
    return out


if __name__ == "__main__":
    main()
