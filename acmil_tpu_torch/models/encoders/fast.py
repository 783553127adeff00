"""The inference path of a ViT trunk over kernels B3, B4 and B5', the port
of ``acmil_tpu/models/encoders/fast.py``.

:func:`vit_encode` runs patch embed → ``depth`` encoder layers → final
layernorm over the state dict of :class:`~acmil_tpu_torch.models.encoders.
vit.ViT`, taking per trunk the route the JAX package takes, decided by the
same predicates (``ops/vit_layer.py``):

1. whole layer, kernel B3 (``fused_vit_layer``): plain gelu, no layerscale,
   and :func:`fits_vmem`, which is the ViT-S/16 class;
2. attention half, kernel B4 (``fused_vit_attn_half``), then
   :func:`_mlp_half`: :func:`attn_half_fits` (ViT-B/16, UNI ViT-L/16,
   ViT-S/8);
3. packed MHA, kernel B5' inside :func:`_xla_attn_half`, then
   :func:`_mlp_half` (CLIP-L/336, GigaPath ViT-G/16).

The MLP half and the attention half of route 3 around B5' are plain
products outside any kernel, in f32 (the param tree's dtype), as XLA runs
them in the JAX package. ``fused=False`` takes every route through the
kernels' plain versions on any device. :func:`vit_route` alone chooses the
route; :func:`cast_kernel_weights` casts the matrices of that route's kernel
once, where a caller keeps the parameters for many batches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from acmil_tpu_torch.models.encoders.vit import mlp_act
from acmil_tpu_torch.ops.vit_attn_packed import (_mm, _reference_packed,
                                                 fused_mha_packed)
from acmil_tpu_torch.ops.vit_layer import (_ln_f32, _reference_attn_half,
                                           _reference_layer,
                                           _unfused_attn_half,
                                           attn_half_fits, fits_vmem,
                                           fused_vit_attn_half,
                                           fused_vit_layer)

# the block matrices each route's kernel chain reads (and casts to x's dtype)
_KERNEL_MATRICES = {
    "layer": ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"),
    "half": ("attn.qkv", "attn.proj"),
    "packed": (),
}


def block_weights(params: dict, i: int) -> dict:
    """Block ``i``'s entries of a ViT state dict, without the
    ``blocks.{i}.`` prefix: the layer-weight dict of ``ops/vit_layer.py``."""
    prefix = f"blocks.{i}."
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _mlp_half(x, bp, act: str):
    """LN2 → fc1 → act → fc2 (·ls2) → +x as plain products on the f32
    weights. bf16 callers get tanh-approximate gelu, f32 callers exact
    gelu, as in the JAX package."""
    f32 = torch.float32
    xf = x.to(f32)
    y = _ln_f32(xf, bp["norm2.weight"], bp["norm2.bias"]).to(x.dtype)
    h = _mm(y, bp["mlp.fc1.weight"].t()) + bp["mlp.fc1.bias"]
    h = mlp_act(h, act, approx_gelu=x.dtype == torch.bfloat16).to(x.dtype)
    h = _mm(h, bp["mlp.fc2.weight"].t()) + bp["mlp.fc2.bias"]
    h = h.to(f32)
    if "ls2.gamma" in bp:
        h = h * bp["ls2.gamma"]
    return (xf + h).to(x.dtype)


def _xla_attn_half(x, bp, heads: int, fused: bool = True):
    """LN1 → qkv → packed MHA (kernel B5') → proj (·ls1) → +x: the route
    for trunks outside :func:`attn_half_fits`."""
    return _unfused_attn_half(x, bp, heads, mha=fused_mha_packed if fused
                              else _reference_packed)


def vit_route(params: dict, n_tok: int, heads: int, dtype: torch.dtype,
              act: str = "gelu") -> str:
    """The route ``vit_encode`` takes for a trunk: ``"layer"`` (kernel B3),
    ``"half"`` (B4) or ``"packed"`` (B5'), by the JAX package's predicates
    at ``n_tok`` tokens padded to 16."""
    dim = params["patch_embed.proj.weight"].shape[0]
    n_pad = (n_tok + 15) // 16 * 16
    hidden = params["blocks.0.mlp.fc1.weight"].shape[0]
    if (act == "gelu" and "blocks.0.ls1.gamma" not in params
            and fits_vmem(dim, hidden, n_pad, heads)):
        return "layer"
    bytes_per_el = torch.tensor([], dtype=dtype).element_size()
    if attn_half_fits(dim, n_pad, heads, g=1, bytes_per_el=bytes_per_el):
        return "half"
    return "packed"


def cast_kernel_weights(params: dict, *, n_tok: int, heads: int,
                        dtype: torch.dtype, act: str = "gelu") -> dict:
    """``params`` with the block matrices that the route's kernel chain
    reads cast to ``dtype`` once. The chains and their plain versions cast
    those matrices to x's dtype on every call, so the result of
    :func:`vit_encode` is the same; the casts leave the per-batch path. The
    MLP half of routes 2 and 3 keeps its f32 matrices."""
    names = _KERNEL_MATRICES[vit_route(params, n_tok, heads, dtype, act)]

    def cast(key):
        parts = key.split(".")
        return (parts[0] == "blocks" and parts[-1] == "weight"
                and ".".join(parts[2:-1]) in names)

    return {k: v.to(dtype) if cast(k) else v for k, v in params.items()}


def vit_encode(params: dict, images: torch.Tensor, *, patch: int, depth: int,
               heads: int, dtype: torch.dtype = torch.bfloat16,
               act: str = "gelu", pre_norm: bool = False, proj_dim=None,
               fused: bool = True) -> torch.Tensor:
    """images ``[B, H, W, 3]`` normalised → cls features ``[B, D or
    proj_dim]`` in ``dtype``.

    ``params``: a :class:`ViT` state dict (timm names), on the images'
    device. The patch embed is a convolution in ``dtype``; on the CPU a
    bf16 convolution is computed in f32 and rounded.
    """
    b = images.shape[0]
    kernel = params["patch_embed.proj.weight"].to(dtype)      # [D, 3, p, p]
    x = images.to(dtype).permute(0, 3, 1, 2)
    if x.device.type == "cpu":
        x = F.conv2d(x.float(), kernel.float(), stride=patch).to(dtype)
    else:
        x = F.conv2d(x, kernel, stride=patch)
    x = x + params["patch_embed.proj.bias"].to(dtype)[:, None, None]
    dim = x.shape[1]
    x = x.flatten(2).transpose(1, 2)                          # [B, P, D]
    cls = params["cls_token"].to(dtype).expand(b, 1, dim)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dtype)
    if pre_norm:
        x = _ln_f32(x.float(), params["norm_pre.weight"],
                    params["norm_pre.bias"]).to(dtype)

    route = vit_route(params, x.shape[1], heads, dtype, act)
    for i in range(depth):
        bp = block_weights(params, i)
        if route == "layer":
            x = (fused_vit_layer if fused else _reference_layer)(x, bp, heads)
        elif route == "half":
            x = (fused_vit_attn_half if fused else _reference_attn_half)(
                x, bp, heads)
            x = _mlp_half(x, bp, act)
        else:
            x = _xla_attn_half(x, bp, heads, fused)
            x = _mlp_half(x, bp, act)

    xn = _ln_f32(x.float(), params["norm.weight"], params["norm.bias"])
    feat = xn[:, 0].to(dtype)
    if proj_dim:
        feat = _mm(feat, params["proj_out.weight"].to(dtype).t())
    return feat
