"""Vision Transformer patch encoders, the port of
``acmil_tpu/models/encoders/vit.py``.

DINO ViT-S/16 (Lunit pathology SSL, 384-d), timm ViT-B/16, UNI ViT-L/16
(layerscale), GigaPath ViT-G/16 (SwiGLU, layerscale) and the CLIP ViT-L/336
variant (pre-norm, quick gelu, output projection ``proj_out``). Parameter
names are timm's (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2,ls1.gamma,
ls2.gamma}``, ``norm_pre``, ``norm``), so timm-layout checkpoints load with
no conversion. Images are NHWC, as in the JAX package.

This module is the plain forward in its parameters' dtype. Step2 extraction
runs ``encoders.fast.vit_encode`` over the same state dict, which routes
each trunk through kernels B3, B4 or B5'.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.ops.vit_layer import LN_EPS


def mlp_act(x, act: str, approx_gelu: bool = False):
    """'gelu' | 'quick_gelu' (OpenAI CLIP) | 'swiglu' (timm SwiGLUPacked:
    fc1 emits twice the true hidden width, gate = silu(first half) * second
    half). ``approx_gelu`` selects tanh-approximate gelu."""
    if act == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if act == "swiglu":
        a, b = torch.chunk(x, 2, dim=-1)
        return F.silu(a) * b
    return F.gelu(x, approximate="tanh" if approx_gelu else "none")


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str = "gelu"):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden // 2 if act == "swiglu" else hidden, dim)

    def forward(self, x):
        return self.fc2(mlp_act(self.fc1(x), self.act))


class SelfAttention(nn.Module):
    """Fused qkv Linear, multi-head attention, output projection.
    ``attn_impl``: 'einsum' (plain tensor code, softmax in f32 when
    ``softmax_f32``) or 'fused' (kernel B5' on the token-major qkv)."""

    def __init__(self, dim: int, heads: int, softmax_f32: bool = True,
                 attn_impl: str = "einsum"):
        super().__init__()
        if attn_impl not in ("einsum", "fused"):
            raise ValueError(f"attn_impl must be 'einsum' or 'fused', got "
                             f"{attn_impl!r}")
        self.dim, self.heads = dim, heads
        self.softmax_f32, self.attn_impl = softmax_f32, attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.qkv(x)
        if self.attn_impl == "fused":
            from acmil_tpu_torch.ops.vit_attn_packed import fused_mha_packed

            return self.proj(fused_mha_packed(qkv, self.heads).to(x.dtype))
        dh = self.dim // self.heads
        q, k, v = (t.reshape(b, n, self.heads, dh).transpose(1, 2)
                   for t in torch.chunk(qkv, 3, dim=-1))
        attn = (q @ k.transpose(-1, -2)) / torch.tensor(dh ** 0.5,
                                                        dtype=x.dtype)
        if self.softmax_f32:
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        else:
            attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 softmax_f32: bool = True, act: str = "gelu",
                 layerscale: bool = False, ls_init: float = 1e-5,
                 attn_impl: str = "einsum"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, heads, softmax_f32, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), act)
        self.ls1 = LayerScale(dim, ls_init) if layerscale else nn.Identity()
        self.ls2 = LayerScale(dim, ls_init) if layerscale else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class ViT(nn.Module):
    """timm/DINO-layout ViT trunk; ``forward(images [B, H, W, 3])`` returns
    the cls-token feature ``[B, proj_dim or dim]``."""

    def __init__(self, patch: int = 16, dim: int = 384, depth: int = 12,
                 heads: int = 6, img_size: int = 224, mlp_ratio: float = 4.0,
                 proj_dim: Optional[int] = None, pre_norm: bool = False,
                 dtype: torch.dtype = torch.float32, softmax_f32: bool = True,
                 act: str = "gelu", layerscale: bool = False,
                 ls_init: float = 1e-5, attn_impl: str = "einsum"):
        super().__init__()
        self.patch, self.dim, self.depth, self.heads = patch, dim, depth, heads
        self.img_size, self.proj_dim, self.pre_norm = img_size, proj_dim, pre_norm
        self.act, self.layerscale = act, layerscale
        # the compute dtype of the extraction path (vit_encode); parameters
        # stay float32, as in the flax module
        self.dtype = dtype
        n_tok = (img_size // patch) ** 2 + 1
        self.patch_embed = _PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, n_tok, dim) * 0.02)
        self.norm_pre = nn.LayerNorm(dim, eps=LN_EPS) if pre_norm else None
        self.blocks = nn.ModuleList(
            ViTBlock(dim, heads, mlp_ratio, softmax_f32, act, layerscale,
                     ls_init, attn_impl) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.proj_out = (nn.Linear(dim, proj_dim, bias=False) if proj_dim
                         else None)

    @property
    def embed_dim(self) -> int:
        return self.proj_dim or self.dim

    def forward(self, images):
        x = self.patch_embed.proj(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                    # [B, P, D]
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x)
        feat = self.norm(x)[:, 0]
        if self.proj_out is not None:
            feat = self.proj_out(feat)
        return feat
