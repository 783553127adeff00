"""Encoder checkpoints into the port's ViT state dict, the port of
``acmil_tpu/models/encoders/convert.py``.

The port's :class:`~acmil_tpu_torch.models.encoders.vit.ViT` uses timm's
names and layouts, so a timm/DINO checkpoint needs only its wrapper prefix
stripped and its extra keys (classifier heads, DINO projection heads)
dropped (:func:`vit_state_dict`). An OpenAI/open_clip visual tower is
renamed key by key (:func:`convert_clip_vit`, the same map as the JAX
package's). The port's ResNet uses torchvision's names, so a torchvision
checkpoint needs its wrapper prefix stripped and its ``fc`` and
``num_batches_tracked`` keys dropped (:func:`resnet_state_dict`); a flax
ResNet's ``params`` and ``batch_stats`` map across with
:func:`resnet_from_flax`. Weights come from local files: there is no
network.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Dict:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "teacher", "student"):
            if key in obj and isinstance(obj[key], dict):
                return obj[key]
    return obj


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def vit_state_dict(state_dict: Dict, depth: int = 12) -> Dict[str, torch.Tensor]:
    """timm/DINO ViT checkpoint → the port's ViT state dict (the keys
    :func:`acmil_tpu.models.encoders.convert.convert_vit` reads, no more)."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    for i in range(depth):
        b = f"blocks.{i}"
        keys += [f"{b}.{m}.{p}" for m in ("norm1", "norm2", "attn.qkv",
                                          "attn.proj", "mlp.fc1", "mlp.fc2")
                 for p in ("weight", "bias")]
        if f"{b}.ls1.gamma" in sd:
            keys += [f"{b}.ls1.gamma", f"{b}.ls2.gamma"]
    out = {k: _f32(sd[k]) for k in keys}
    out["cls_token"] = out["cls_token"].reshape(1, 1, -1)
    return out


def convert_clip_vit(state_dict: Dict, depth: int = 24) -> Dict[str, torch.Tensor]:
    """OpenAI/open_clip visual tower → the port's ViT state dict (for the
    ``path-clip-L-336`` / ``openai-clip-L-336`` encoders).

    open_clip layout: ``visual.conv1`` (bias-free patch embed),
    ``class_embedding``, ``positional_embedding``, ``ln_pre``,
    ``transformer.resblocks.N.{ln_1, attn.in_proj_*, attn.out_proj, ln_2,
    mlp.c_fc, mlp.c_proj}``, ``ln_post``, ``proj`` ``[D, proj_dim]``.
    """
    sd = {k[len("visual."):] if k.startswith("visual.") else k: v
          for k, v in state_dict.items() if not k.startswith("text")}
    cls = _f32(sd["class_embedding"]).reshape(-1)
    dim = cls.shape[0]
    p = {
        "cls_token": cls.reshape(1, 1, dim),
        "pos_embed": _f32(sd["positional_embedding"]).reshape(1, -1, dim),
        "patch_embed.proj.weight": _f32(sd["conv1.weight"]),
        "patch_embed.proj.bias": torch.zeros(dim),   # CLIP conv1 is bias-free
        "norm_pre.weight": _f32(sd["ln_pre.weight"]),
        "norm_pre.bias": _f32(sd["ln_pre.bias"]),
        "norm.weight": _f32(sd["ln_post.weight"]),
        "norm.bias": _f32(sd["ln_post.bias"]),
        "proj_out.weight": _f32(sd["proj"]).T.contiguous(),
    }
    names = {"ln_1": "norm1", "ln_2": "norm2", "attn.out_proj": "attn.proj",
             "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}
    for i in range(depth):
        src, dst = f"transformer.resblocks.{i}", f"blocks.{i}"
        p[f"{dst}.attn.qkv.weight"] = _f32(sd[f"{src}.attn.in_proj_weight"])
        p[f"{dst}.attn.qkv.bias"] = _f32(sd[f"{src}.attn.in_proj_bias"])
        for old, new in names.items():
            for q in ("weight", "bias"):
                p[f"{dst}.{new}.{q}"] = _f32(sd[f"{src}.{old}.{q}"])
    return p


_RESNET_TOP = ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")


def resnet_state_dict(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """torchvision ResNet checkpoint → the port's ResNet state dict: the
    trunk's convolutions and batch norms (the keys
    :func:`acmil_tpu.models.encoders.convert.convert_resnet` reads), with
    ``module.`` stripped."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    return {k: _f32(v) for k, v in sd.items()
            if k.split(".", 1)[0] in _RESNET_TOP
            and not k.endswith("num_batches_tracked")}


def resnet_from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``encoders.resnet.ResNet``'s ``params`` and ``batch_stats`` →
    the port's state dict: conv kernels HWIO → OIHW; batch norm scale, bias,
    mean and var → weight, bias, running_mean and running_var;
    ``layerI_J`` → ``layerI.J`` and ``down_conv``/``down_bn`` →
    ``downsample.0``/``downsample.1``."""
    out: Dict[str, torch.Tensor] = {}

    def conv(name, p):
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)))

    def bn(name, p, st):
        for key, v in (("weight", p["scale"]), ("bias", p["bias"]),
                       ("running_mean", st["mean"]), ("running_var", st["var"])):
            out[f"{name}.{key}"] = torch.from_numpy(np.array(v, np.float32))

    names = {"down_conv": "downsample.0", "down_bn": "downsample.1"}
    for top, p in params.items():
        prefix = top.replace("_", ".")
        if "kernel" in p:
            conv(prefix, p)
        elif top.startswith("bn"):
            bn(prefix, p, batch_stats[top])
        else:
            for sub, q in p.items():
                name = f"{prefix}.{names.get(sub, sub)}"
                if "kernel" in q:
                    conv(name, q)
                else:
                    bn(name, q, batch_stats[top][sub])
    return out
