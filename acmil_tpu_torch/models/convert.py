"""Weights across the two packages: a flax parameter tree of
``acmil_tpu.models.acmil`` or of an ``encoders.vit.ViT`` (as numpy arrays) →
the port's ``state_dict``.

flax kernels are ``[in, out]``, torch weights ``[out, in]``; ACMIL_GA's
stacked branch classifiers ``branch_w [K, L, C]`` / ``branch_b [K, C]``
become ``classifier.{k}.fc.*``. The inverse is
``scripts/import_torch_checkpoint.py::convert_acmil_ga``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, prefix, dense):
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        sd[f"{prefix}.bias"] = _t(dense["bias"])


def _layernorm(sd, prefix, ln):
    sd[f"{prefix}.weight"] = _t(ln["scale"])
    sd[f"{prefix}.bias"] = _t(ln["bias"])


def _vit(params) -> Dict[str, torch.Tensor]:
    """A flax ``encoders.vit.ViT`` tree → the port's ViT state dict:
    ``patch_embed`` HWIO → OIHW, ``block{i}`` → ``blocks.{i}`` with
    ``Dense_0``/``Dense_1`` → ``mlp.fc1``/``mlp.fc2`` (any widths, so SwiGLU's
    too), ``ls1``/``ls2`` → ``ls{1,2}.gamma``, and ``norm_pre`` and
    ``proj_out`` where present."""
    pe = params["patch_embed"]
    sd = {"patch_embed.proj.weight": _t(np.asarray(pe["kernel"])
                                        .transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": _t(pe["bias"]),
          "cls_token": _t(params["cls_token"]),
          "pos_embed": _t(params["pos_embed"])}
    for name in ("norm_pre", "norm"):
        if name in params:
            _layernorm(sd, name, params[name])
    if "proj_out" in params:
        _linear(sd, "proj_out", params["proj_out"])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk, pre = params[f"block{i}"], f"blocks.{i}"
        _layernorm(sd, f"{pre}.norm1", blk["norm1"])
        _layernorm(sd, f"{pre}.norm2", blk["norm2"])
        _linear(sd, f"{pre}.attn.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", blk["attn"]["proj"])
        _linear(sd, f"{pre}.mlp.fc1", blk["mlp"]["Dense_0"])
        _linear(sd, f"{pre}.mlp.fc2", blk["mlp"]["Dense_1"])
        for ls in ("ls1", "ls2"):
            if ls in blk:
                sd[f"{pre}.{ls}.gamma"] = _t(blk[ls])
    return sd


def from_jax_params(params, arch: str) -> Dict[str, torch.Tensor]:
    """``arch`` is ``"ga"`` (ACMIL_GA), ``"abmil"`` or ``"vit"`` (a patch
    encoder of ``acmil_tpu.models.encoders.vit``)."""
    if arch == "vit":
        return _vit(params)
    if arch not in ("ga", "abmil"):
        raise ValueError(f"no converter for arch {arch!r} (have 'ga', "
                         f"'abmil', 'vit')")
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    ag = params["AttentionGated_0"]
    _linear(sd, "attention.attention_V.0", ag["Dense_0"])
    _linear(sd, "attention.attention_U.0", ag["Dense_1"])
    _linear(sd, "attention.attention_weights", ag["Dense_2"])
    cls = params["Classifier1fc_0"]["Dense_0"]
    if arch == "abmil":
        _linear(sd, "classifier.fc", cls)
        return sd
    for k, (w, b) in enumerate(zip(np.asarray(params["branch_w"]),
                                   np.asarray(params["branch_b"]))):
        sd[f"classifier.{k}.fc.weight"] = _t(w.T)
        sd[f"classifier.{k}.fc.bias"] = _t(b)
    _linear(sd, "Slide_classifier.fc", cls)
    return sd
