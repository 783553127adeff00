"""Plain reference of a ViT patch encoder's features (Dosovitskiy et al.,
ICLR 2021; timm's ``VisionTransformer`` layout, which both trunks follow:
DINO ViT-S/16 and UNI's DINOv2 ViT-L/16 with layer scale): uint8 pixels to
the cls token after the final LayerNorm, in f32 with TF32 off, on the same
state dict (timm names) the program is given. It imports nothing of the
program.

``x = ((pixels / 255) - mean) / std``; the patch embed as a product over
each patch's ``3 p p`` pixels (the convolution's weight flattened in its
(channel, row, column) order); the cls token and the position embedding;
per block ``x += ls1 * proj(attn(LN1(x)))``, ``x += ls2 * fc2(gelu(fc1(
LN2(x))))`` with the exact (erf) gelu of the published models; the final
LayerNorm's cls row. Every product goes through ``precision.mm``: ``f32``
is the reference, ``fp8`` its control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from harness.precision import exact_f32, mm


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _linear(x, params, name, prec):
    return mm(x, params[name + ".weight"].t(), prec) + params[name + ".bias"]


def features(params, images: torch.Tensor, trunk: dict,
             prec: str = "f32", block: int = 32) -> torch.Tensor:
    """uint8 ``[n, H, W, 3]`` on the weights' device -> ``[n, dim]`` f32,
    ``block`` images at a time."""
    with torch.no_grad(), exact_f32():
        return torch.cat([_features(params, images[i:i + block], trunk, prec)
                          for i in range(0, images.shape[0], block)])


def _features(params, images, trunk, prec):
    p, d, heads, eps = (trunk["patch"], trunk["dim"], trunk["heads"],
                        trunk["ln_eps"])
    dev = images.device
    mean = torch.tensor(trunk["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(trunk["std"], dtype=torch.float32, device=dev)
    x = (images.float() / 255.0 - mean) / std                  # [n, H, W, 3]
    n, hh, ww, _ = x.shape
    x = x.permute(0, 3, 1, 2).reshape(n, 3, hh // p, p, ww // p, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(n, (hh // p) * (ww // p),
                                             3 * p * p)
    w = params["patch_embed.proj.weight"].reshape(d, -1)
    x = mm(x, w.t(), prec) + params["patch_embed.proj.bias"]
    cls = params["cls_token"].expand(n, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    t = x.shape[1]
    dh = d // heads
    for i in range(trunk["depth"]):
        b = f"blocks.{i}."
        y = _ln(x, params[b + "norm1.weight"], params[b + "norm1.bias"], eps)
        qkv = _linear(y, params, b + "attn.qkv", prec)
        q, k, v = qkv.reshape(n, t, 3, heads, dh).permute(2, 0, 3, 1, 4)
        att = torch.softmax(mm(q, k.transpose(-1, -2), prec) / dh ** 0.5,
                            dim=-1)
        o = mm(att, v, prec).transpose(1, 2).reshape(n, t, d)
        o = _linear(o, params, b + "attn.proj", prec)
        if trunk["layerscale"]:
            o = o * params[b + "ls1.gamma"]
        x = x + o
        y = _ln(x, params[b + "norm2.weight"], params[b + "norm2.bias"], eps)
        h = F.gelu(_linear(y, params, b + "mlp.fc1", prec))
        h = _linear(h, params, b + "mlp.fc2", prec)
        if trunk["layerscale"]:
            h = h * params[b + "ls2.gamma"]
        x = x + h
    return _ln(x, params["norm.weight"], params["norm.bias"], eps)[:, 0]
