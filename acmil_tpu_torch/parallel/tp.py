"""Tensor-parallel ViT extraction (Megatron over a ``(data, model)`` mesh of
processes), the port of ``acmil_tpu/parallel/tp.py``.

Attention heads and the MLP hidden units of every block are split over the
mesh's ``model`` ranks, so each rank holds ``1/tp`` of every block's big
matrices and a layer costs two all-reduces of the ``[b, N, D]`` activations
over the model group (after the attention projection and after fc2).

Layout per block of the port's timm-named state dict
(``blocks.{i}.…``, weights ``[out, in]``):

- ``attn.qkv`` weight ``[3D, D]`` and bias: rows sliced by head, in the
  packed ``(3, H, dh)`` order, so a rank keeps its ``H/tp`` heads of q, k
  and v (``[3·Hl·dh, D]``);
- attention runs on the local heads only, through kernel B7 on CUDA
  tensors (``ops/vit_attn.py``, reading the local qkv through strided
  views and writing a token-major buffer) and its plain version on CPU
  tensors;
- ``attn.proj`` weight ``[D, D]``: columns sliced by the same heads; the
  partial products are summed over the model group, the bias added once;
- ``mlp.fc1`` weight and bias: rows sliced on the hidden axis (for the
  SwiGLU-packed GigaPath trunk both halves of ``[2h, D]`` are sliced on h,
  so the gate stays local);
- ``mlp.fc2`` weight ``[D, h]``: columns sliced the same way, summed, the
  bias added once;
- layernorms, layerscale, patch embed, cls/pos tokens, ``norm_pre``, the
  final norm and the CLIP ``proj_out`` are replicated.

The layernorms keep f32 statistics, bf16 trunks get the tanh-approximate
gelu of the one-process route, and the products outside B7 are plain
``F.linear`` products in the trunk's dtype, as XLA runs them in the JAX
package. Extraction is inference only: the all-reduces are plain
``dist.all_reduce`` calls (``parallel/collectives.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from acmil_tpu_torch.models.encoders.fast import (block_weights, vit_embed,
                                                  vit_head)
from acmil_tpu_torch.models.encoders.vit import mlp_act
from acmil_tpu_torch.ops.vit_attn import fused_vit_attention
from acmil_tpu_torch.ops.vit_layer import _ln_f32
from acmil_tpu_torch.parallel import collectives as C

# a block's entries that are sliced over the model ranks; every other entry
# is replicated
_SHARDED = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
            "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")
# the block matrices of the plain products
_MATRICES = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
             "mlp.fc2.weight")


def _slice_block(bp: dict, heads: int, tp: int, index: int,
                 act: str = "gelu") -> dict:
    """One block's entries (``ops/vit_layer.py`` names, no ``blocks.{i}.``
    prefix) → model rank ``index``'s slice of them; replicated entries pass
    through unchanged."""
    qkv_w = bp["attn.qkv.weight"]
    dh = qkv_w.shape[0] // (3 * heads)
    if heads % tp:
        raise ValueError(f"heads {heads} not divisible by tp {tp}")
    hl = heads // tp
    hidden = bp["mlp.fc2.weight"].shape[1]   # fc2's input: the true hidden
    if hidden % tp:
        raise ValueError(f"hidden {hidden} not divisible by tp {tp}")
    hlocal = hidden // tp
    packs = 2 if act == "swiglu" else 1

    def head_rows(a):     # [3D, ...] packed (3, H, dh) → [3·Hl·dh, ...]
        a = a.reshape((3, tp, hl * dh) + a.shape[1:])[:, index]
        return a.reshape((3 * hl * dh,) + a.shape[2:])

    def hid_rows(a):      # fc1 outputs [packs·h, ...] → [packs·h/tp, ...]
        a = a.reshape((packs, tp, hlocal) + a.shape[1:])[:, index]
        return a.reshape((packs * hlocal,) + a.shape[2:])

    cols = slice(index * hl * dh, (index + 1) * hl * dh)
    hcols = slice(index * hlocal, (index + 1) * hlocal)
    out = dict(bp)
    out["attn.qkv.weight"] = head_rows(qkv_w)
    out["attn.qkv.bias"] = head_rows(bp["attn.qkv.bias"])
    out["attn.proj.weight"] = bp["attn.proj.weight"][:, cols]
    out["mlp.fc1.weight"] = hid_rows(bp["mlp.fc1.weight"])
    out["mlp.fc1.bias"] = hid_rows(bp["mlp.fc1.bias"])
    out["mlp.fc2.weight"] = bp["mlp.fc2.weight"][:, hcols]
    return {k: v.contiguous() for k, v in out.items()}


def shard_vit_params_tp(params: dict, *, heads: int, tp: int, index: int,
                        act: str = "gelu") -> dict:
    """A ViT state dict (timm names) → model rank ``index``'s share of it:
    every block's :data:`_SHARDED` entries sliced to ``1/tp``, everything
    else replicated. Raises ValueError when heads or the hidden width do
    not divide by ``tp``."""
    out = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    depth = 1 + max((int(k.split(".")[1]) for k in params
                     if k.startswith("blocks.")), default=-1)
    for i in range(depth):
        local = _slice_block(block_weights(params, i), heads, tp, index, act)
        out.update({f"blocks.{i}.{k}": v for k, v in local.items()})
    return out


def _tp_block(x: torch.Tensor, bp: dict, heads_local: int, act: str,
              group) -> torch.Tensor:
    """One transformer block on this rank's heads and hidden slice: two
    all-reduces over ``group`` (the model group). The block matrices are in
    x's dtype already (:func:`tp_encoder_feature_fn` casts them once)."""
    f32 = torch.float32
    dt = x.dtype
    xf = x.float()
    y = _ln_f32(xf, bp["norm1.weight"], bp["norm1.bias"]).to(dt)
    qkv = F.linear(y, bp["attn.qkv.weight"].to(dt),
                   bp["attn.qkv.bias"].to(dt))
    b, n, _ = qkv.shape
    dh = qkv.shape[-1] // (3 * heads_local)
    q, k, v = qkv.view(b, n, 3, heads_local, dh).permute(2, 0, 3, 1, 4)
    attn = torch.empty(b, n, heads_local * dh, dtype=dt, device=x.device)
    fused_vit_attention(q, k, v,
                        out=attn.view(b, n, heads_local, dh).transpose(1, 2))

    part = F.linear(attn, bp["attn.proj.weight"].to(dt)).to(f32)
    y2 = C.all_reduce_(part, group) + bp["attn.proj.bias"].to(f32)
    if "ls1.gamma" in bp:
        y2 = y2 * bp["ls1.gamma"].to(f32)
    xf = xf + y2

    y = _ln_f32(xf, bp["norm2.weight"], bp["norm2.bias"]).to(dt)
    h = F.linear(y, bp["mlp.fc1.weight"].to(dt), bp["mlp.fc1.bias"].to(dt))
    h = mlp_act(h, act, approx_gelu=dt == torch.bfloat16).to(dt)
    part = F.linear(h, bp["mlp.fc2.weight"].to(dt)).to(f32)
    h2 = C.all_reduce_(part, group) + bp["mlp.fc2.bias"].to(f32)
    if "ls2.gamma" in bp:
        h2 = h2 * bp["ls2.gamma"].to(f32)
    return (xf + h2).to(dt)


def _tp_vit_local(params: dict, images: torch.Tensor, *, patch: int,
                  depth: int, heads_local: int, act: str, pre_norm: bool,
                  proj_dim, dtype: torch.dtype, group) -> torch.Tensor:
    """This rank's forward: normalised images ``[b, S, S, 3]`` → cls
    features ``[b, D or proj_dim]`` in ``dtype``, the blocks on this rank's
    share of the parameters (:func:`shard_vit_params_tp`), the rest
    replicated."""
    x = vit_embed(params, images, patch=patch, dtype=dtype,
                  pre_norm=pre_norm)
    for i in range(depth):
        x = _tp_block(x, block_weights(params, i), heads_local, act, group)
    return vit_head(params, x, proj_dim)


def broadcast_images(images_u8, mesh, shape, device: torch.device
                     ) -> torch.Tensor:
    """The model group's first rank's uint8 image block on every rank of the
    group, on ``device``: that rank passes its block (numpy), the others
    None and receive it (``shape`` is the block's). Only the first rank of
    a model group reads the slide, so a batch is read once per data rank
    and not once per model rank."""
    if mesh.model_index == 0:
        t = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    else:
        t = torch.empty(shape, dtype=torch.uint8, device=device)
    return C.broadcast_(t, mesh.rank - mesh.model_index, mesh.model_group)


def tp_encoder_feature_fn(model, spec, mesh, device: torch.device,
                          out_dtype: torch.dtype = torch.float16):
    """Tensor-parallel counterpart of
    :func:`~acmil_tpu_torch.models.encoders.build.encoder_feature_fn`: this
    rank's block of a uint8 image batch (``patch_dataset.shard_rows``;
    numpy or a uint8 tensor on ``device``) → the features of the whole
    padded batch ``[data · rows, embed_dim]`` in ``out_dtype``, gathered
    over the data group. The trunk runs ``1/tp`` a rank over the mesh's model group; the
    ranks of one model group must pass the same block. ViT trunks only."""
    from acmil_tpu_torch.models.encoders.build import (gather_rows,
                                                       preprocess,
                                                       to_device)
    from acmil_tpu_torch.models.encoders.vit import ViT

    enc = model.encoder
    if not isinstance(enc, ViT):
        raise ValueError(
            f"tensor parallelism supports ViT trunks only, got "
            f"{type(enc).__name__}; use the data-parallel path (--mesh_data)")
    tp = mesh.model
    local = shard_vit_params_tp(
        {k: v.detach() for k, v in enc.state_dict().items()},
        heads=enc.heads, tp=tp, index=mesh.model_index, act=enc.act)
    # the block matrices in the trunk's dtype once, as _tp_block reads them
    params = {k: v.to(device, enc.dtype) if k.startswith("blocks.")
              and k.endswith(_MATRICES) else v.to(device)
              for k, v in local.items()}
    heads_local = enc.heads // tp

    @torch.no_grad()
    def feat_fn(images_u8):
        x = preprocess(to_device(images_u8, device), spec, dtype=enc.dtype)
        feats = _tp_vit_local(
            params, x, patch=enc.patch, depth=enc.depth,
            heads_local=heads_local, act=enc.act, pre_norm=enc.pre_norm,
            proj_dim=enc.proj_dim, dtype=enc.dtype, group=mesh.model_group)
        return gather_rows(feats.to(out_dtype), mesh)

    return feat_fn


__all__ = ["broadcast_images", "shard_vit_params_tp", "tp_encoder_feature_fn"]
