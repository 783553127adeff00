"""Plain reference of a SwiGLU ViT patch encoder's features: the
Prov-GigaPath tile encoder (Xu et al., Nature 2024), timm's
``VisionTransformer`` as ``vit_giant_patch14_dinov2`` builds it at patch
16 (DINOv2 ViT-g: ``SwiGLUPacked`` MLP, layer scale, LayerNorm eps 1e-6):
uint8 pixels to the cls token after the final LayerNorm, in f32 with TF32
off, on the same state dict (timm names) the program is given. It imports
nothing of the program.

``x = ((pixels / 255) - mean) / std``; the patch embed as a product over
each patch's ``3 p p`` pixels (the convolution's weight flattened in its
(channel, row, column) order); the cls token and the position embedding;
per block ``x += ls1 * proj(attn(LN1(x)))``, then ``x += ls2 * fc2(silu(a)
* b)`` with ``a, b`` the two halves of ``fc1(LN2(x))`` (``SwiGLUPacked``:
fc1 to the packed width ``mlp_hidden``, silu on the first half, fc2 from
half of it); the final LayerNorm's cls row (``global_pool="token"``, no
head). Every product goes through ``precision.mm``: ``f32`` is the
reference, ``fp8`` its control.

Departures from the published model: the weights are the ones handed in
(the benchmark's are seeded random, with layer scales near 0.5 rather than
the 1e-5 they start from), and every product and the softmax are f32,
where the published model runs in whatever precision its user picks.
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
        x = x + _linear(o, params, b + "attn.proj", prec) * \
            params[b + "ls1.gamma"]
        y = _ln(x, params[b + "norm2.weight"], params[b + "norm2.bias"], eps)
        gate, value = _linear(y, params, b + "mlp.fc1", prec).chunk(2, dim=-1)
        h = _linear(F.silu(gate) * value, params, b + "mlp.fc2", prec)
        x = x + h * params[b + "ls2.gamma"]
    return _ln(x, params["norm.weight"], params["norm.bias"], eps)[:, 0]
