"""MHIM, masked hard instance mining with an EMA teacher: the port of
``acmil_tpu/models/mhim.py`` (reference: `modules/mhim.py` ``MHIM:36``,
``select_mask_fn:79``, ``get_mask:139``; `modules/satten.py` ``SAttention:30``;
`modules/datten.py` ``DAttention:85``).

The masks are the JAX package's boolean composes over the static padded
bag, not the reference's shrinking of the sequence: "drop ceil(ps·r)
patches by score" is ``rank(score) < ps·r``, with ``rank`` an argsort of an
argsort (stable, so ties break by position as in ``jnp.argsort``) and ``ps``
the bag's valid count, in float32. Random masking ranks uniforms; low- and
high-attention masking rank the teacher's attention; the random subset of
the high-attention set (``mask_ratio_hr``) re-ranks the candidates by fresh
uniforms. The encoders are mask-aware, so clearing a patch's mask bit is the
reference's removing it from the sequence.

Uniforms come from a ``torch.Generator``, or are passed in as ``mask_u
[2, B, N]`` (random masking, then the high-attention subset): the JAX
package draws them with ``jax.random.uniform``, whose bits torch cannot
reproduce, so a test hands both packages the same draws.

Module and parameter names are the reference's (``patch_to_emb.0``,
``online_encoder``, ``predictor``), so a reference ``state_dict`` loads as it
is and ``scripts/import_torch_checkpoint.py::convert_mhim`` reads the
port's. Linear layers are xavier-normal with zero biases (the reference's
``initialize_weights``); convs keep torch's default.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.models.common import dropout, xavier_normal_init_
from acmil_tpu_torch.models.emb_position import PEG, SINCOS
from acmil_tpu_torch.models.transmil import (LN_EPS, PPEG, TransLayer,
                                             _grid_shape, wrap_to_grid)
from acmil_tpu_torch.ops.masked import masked_softmax

_F32 = torch.float32


def _act(name: str):
    """flax's ``nn.gelu`` is the tanh approximation (convention C4)."""
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": torch.relu, "tanh": torch.tanh}[name]


# ---------------------------------------------------------------------------
# rank-based masking
# ---------------------------------------------------------------------------

def _rank(scores: torch.Tensor, valid: torch.Tensor, largest: bool) -> torch.Tensor:
    """Dense rank (0 = best) of the valid entries along the last axis;
    invalid entries rank worst; ties by position."""
    fill = -math.inf if largest else math.inf
    s = torch.where(valid, scores, torch.full_like(scores, fill))
    order = torch.argsort(-s if largest else s, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


def select_drop_mask(scores: torch.Tensor, valid: torch.Tensor, frac,
                     largest: bool, noise: Optional[torch.Tensor] = None,
                     random_frac: float = 1.0) -> torch.Tensor:
    """Boolean drop mask over the bag ``[B, N]``: the top (or bottom)
    ``ceil(ps · frac)`` scored valid patches, or with ``random_frac`` < 1 a
    random ``ceil(ps · frac)`` of the ``ceil(ps · frac / random_frac)`` best,
    by the uniforms ``noise [B, N]`` (`select_mask_fn`,
    `modules/mhim.py:79-120`). ``frac`` is a float or a float32 tensor; the
    counts are float32 products, as in JAX."""
    dev = scores.device
    ps = valid.sum(dim=-1, keepdim=True).to(_F32)
    if random_frac >= 1.0:
        k = torch.ceil(ps * _f32(frac, dev))
        return (_rank(scores, valid, largest) < k) & valid
    if isinstance(frac, torch.Tensor):
        cand_frac = torch.clamp(frac.to(_F32) / max(random_frac, 1e-8), max=1.0)
    else:
        cand_frac = min(frac / max(random_frac, 1e-8), 1.0)
    k_cand = torch.ceil(ps * _f32(cand_frac, dev))
    cand = (_rank(scores, valid, largest) < k_cand) & valid
    if noise is None:
        raise ValueError("random_frac < 1 needs the uniforms `noise`")
    k_drop = torch.ceil(ps * _f32(frac, dev))
    return (_rank(noise, cand, largest=False) < k_drop) & cand


def fuse_heads_vote(attn: torch.Tensor, valid: torch.Tensor, frac) -> torch.Tensor:
    """'vote' fusion of per-head attention ``[B, H, N]`` (`mhim.py:101-113`):
    each head nominates its top ``ceil(ps · frac)``; returns the vote count
    per patch ``[B, N]`` (float32)."""
    ps = valid.sum(dim=-1, keepdim=True).to(_F32)[:, None]
    k = torch.ceil(ps * _f32(frac, attn.device))
    rank_h = _rank(attn, valid[:, None, :], largest=True)
    return (rank_h < k).sum(dim=1).to(_F32)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

class SAttentionEncoder(nn.Module):
    """Two Nystrom layers with a cls token and a positional embedding
    between them (`modules/satten.py:30-122`; ``pos`` ppeg, peg, sincos or
    none). ``cls_token``, ``layer1``, ``pos_embedding``, ``layer2`` and
    ``norm`` as the reference names them. ``pad_mode="wrap"`` (ppeg only)
    keeps the reference's numerics for serving its checkpoints: the Nystrom
    front pads attend as real rows and the PPEG grid is filled by wrapping
    the valid rows to the reference's ``ceil(sqrt(n_valid))²`` window,
    zero-filled up to 7x7 when smaller.

    Returns the cls feature ``[B, dim]``, and with ``return_attn`` also each
    layer's cls attention over the bag ``[[B, N], [B, N]]``."""

    def __init__(self, dim: int = 512, pos: str = "ppeg",
                 dtype: torch.dtype = _F32, pad_mode: str = "zero",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pad_mode not in ("zero", "wrap"):
            raise ValueError(f"pad_mode must be zero|wrap, got {pad_mode!r}")
        if pad_mode == "wrap" and pos != "ppeg":
            raise ValueError(
                "pad_mode='wrap' implements the reference's PPEG grid "
                f"wrapping only; use pad_mode='zero' with pos={pos!r}")
        if pos not in ("ppeg", "peg", "sincos", "none"):
            raise ValueError(f"pos must be ppeg|peg|sincos|none, got {pos!r}")
        self.pos, self.pad_mode = pos, pad_mode
        strict = pad_mode == "wrap"
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        with torch.no_grad():
            self.cls_token.normal_(0.0, 1.0, generator=generator)
        self.layer1 = TransLayer(dim, dtype, strict, generator, init="xavier")
        if pos == "ppeg":
            self.pos_embedding = PPEG(dim, generator)
        elif pos == "peg":
            self.pos_embedding = PEG(dim, generator=generator)
        elif pos == "sincos":
            self.pos_embedding = SINCOS(dim)
        self.layer2 = TransLayer(dim, dtype, strict, generator, init="xavier")
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        strict = self.pad_mode == "wrap"
        gh, gw = _grid_shape(n, square=strict)
        grid_n = gh * gw
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
        if grid_n > n and not strict:
            x = F.pad(x, (0, 0, 0, grid_n - n))
            mask = F.pad(mask, (0, grid_n - n))
        x = x * mask[..., None].to(x.dtype)
        h = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x], dim=1)
        fmask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                      device=x.device), mask], dim=1)

        def rezero(t):
            return t * fmask[..., None].to(t.dtype)

        attns = []
        if return_attn:
            h, a1 = self.layer1(h, fmask, deterministic, 1, generator)
            attns.append(a1[:, 0, 1:1 + n])
        else:
            h = self.layer1(h, fmask, deterministic, generator=generator)
        if self.pos == "ppeg" and strict:
            body, _ = wrap_to_grid(h[:, 1:], mask, grid_n)
            if gh < 7:
                body = F.pad(body, (0, 0, 0, 49 - grid_n))
                gh = gw = 7
            hp = self.pos_embedding(torch.cat([h[:, :1], body], 1), gh, gw)
            h = rezero(torch.cat([h[:, :1], hp[:, 1:1 + n]], dim=1))
        elif self.pos == "ppeg":
            h = rezero(self.pos_embedding(rezero(h), gh, gw))
        elif self.pos in ("peg", "sincos"):
            # rezero before the positional conv too: masked slots are
            # nonzero after the first layer
            body = self.pos_embedding(rezero(h)[:, 1:], gh, gw)
            h = rezero(torch.cat([h[:, :1], body], dim=1))
        if return_attn:
            h, a2 = self.layer2(h, fmask, deterministic, 1, generator)
            attns.append(a2[:, 0, 1:1 + n])
        else:
            h = self.layer2(h, fmask, deterministic, generator=generator)
        cls_feat = self.norm(h[:, 0])
        if return_attn:
            return cls_feat, attns
        return cls_feat


class _Attention(nn.Module):
    """The reference's ungated ``Attention`` (`modules/datten.py`):
    ``attention`` = Linear(dim, 128), act, Linear(128, 1), bias-free."""

    def __init__(self, dim: int, act: str):
        super().__init__()
        self.act = act
        self.attention = nn.Sequential(nn.Linear(dim, 128, bias=False),
                                       nn.Identity(),
                                       nn.Linear(128, 1, bias=False))

    def forward(self, x):
        return self.attention[2](_act(self.act)(self.attention[0](x)))


class _AttentionGated(nn.Module):
    """The reference's ``AttentionGated``: ``attention_a`` (Linear, act),
    ``attention_b`` (Linear, Sigmoid), ``attention_c``, bias-free."""

    def __init__(self, dim: int, act: str):
        super().__init__()
        self.act = act
        self.attention_a = nn.Sequential(nn.Linear(dim, 128, bias=False))
        self.attention_b = nn.Sequential(nn.Linear(dim, 128, bias=False))
        self.attention_c = nn.Linear(128, 1, bias=False)

    def forward(self, x):
        av = _act(self.act)(self.attention_a[0](x))
        au = torch.sigmoid(self.attention_b[0](x))
        return self.attention_c(av * au)


class DAttentionEncoder(nn.Module):
    """Attention pooling (`modules/datten.py`, ``DAttention(dim, act,
    gated, bias=False)``): returns the pooled feature ``[B, dim]``, and with
    ``return_attn`` also the attention logits ``[[B, N]]``."""

    def __init__(self, dim: int = 512, gated: bool = False, act: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attention = (_AttentionGated if gated else _Attention)(dim, act)
        xavier_normal_init_(self, generator)

    def forward(self, x, mask=None, deterministic: bool = True,
                return_attn: bool = False, generator=None):
        a = self.attention(x).transpose(-1, -2)                   # [B,1,N]
        attn = masked_softmax(a, None if mask is None else mask[:, None, :])
        pooled = torch.einsum("bkn,bnd->bkd", attn, x)[:, 0]
        if return_attn:
            return pooled, [a[:, 0]]
        return pooled


class MHIM(nn.Module):
    """The student and teacher network (`modules/mhim.py:36`): ``patch_to_emb``
    (Linear, act, dropout), an ``online_encoder`` (``SAttentionEncoder`` for
    ``baseline="selfattn"``, ``DAttentionEncoder`` for ``"attn"``) and a
    ``predictor``.

    ``forward`` returns ``{"logits", "cls_feat", "keep"}`` (``"attn"`` too
    with ``return_attn``: layer ``attn_layer``'s). In training
    (``deterministic=False``) it drops patches from the mask: random
    (``mask_ratio``), and by ``teacher_attn`` the low-attention
    (``mask_ratio_l``) and high-attention ones (``mask_ratio_h``, or the
    scheduled ``mask_ratio_h`` argument, a random ``mask_ratio_hr`` share of
    a larger candidate set)."""

    def __init__(self, n_class: int, d_feat: int, mlp_dim: int = 512,
                 baseline: str = "selfattn", act: str = "relu",
                 da_act: str = "gelu", droprate: float = 0.25,
                 mask_ratio: float = 0.0, mask_ratio_l: float = 0.0,
                 mask_ratio_h: float = 0.0, mask_ratio_hr: float = 1.0,
                 attn_layer: int = 0, pos: str = "ppeg",
                 pad_mode: str = "zero", dtype: torch.dtype = _F32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if baseline not in ("selfattn", "attn"):
            raise ValueError(f"baseline must be selfattn|attn, got {baseline!r}")
        self.act, self.droprate = act, droprate
        self.mask_ratio, self.mask_ratio_l = mask_ratio, mask_ratio_l
        self.mask_ratio_h, self.mask_ratio_hr = mask_ratio_h, mask_ratio_hr
        self.attn_layer = attn_layer
        self.patch_to_emb = nn.Sequential(nn.Linear(d_feat, mlp_dim))
        xavier_normal_init_(self.patch_to_emb, generator)
        if baseline == "selfattn":
            self.online_encoder = SAttentionEncoder(mlp_dim, pos, dtype,
                                                    pad_mode, generator)
        else:
            self.online_encoder = DAttentionEncoder(mlp_dim, act=da_act,
                                                    generator=generator)
        self.predictor = xavier_normal_init_(nn.Linear(mlp_dim, n_class),
                                             generator)

    def _drop(self, mask, teacher_attn, mask_ratio_h, mask_u, generator):
        b, n = mask.shape
        if mask_u is None:
            mask_u = torch.rand((2, b, n), generator=generator,
                                device=mask.device)
        elif tuple(mask_u.shape) != (2, b, n):
            raise ValueError(f"mask_u must be [2, {b}, {n}], got "
                             f"{tuple(mask_u.shape)}")
        drop = torch.zeros_like(mask)
        if self.mask_ratio > 0:
            drop |= select_drop_mask(mask_u[0], mask, self.mask_ratio,
                                     largest=True)
        if teacher_attn is None:
            return drop

        def score(ta, frac, largest):
            s = ta if largest else -ta
            if ta.dim() == 3:                 # [B, H, N]: vote over heads
                return fuse_heads_vote(s, mask, frac)
            return s

        ta = teacher_attn.detach()
        if self.mask_ratio_l > 0:
            drop |= select_drop_mask(score(ta, self.mask_ratio_l, False),
                                     mask, self.mask_ratio_l, largest=True)
        mrh = self.mask_ratio_h if mask_ratio_h is None else mask_ratio_h
        if mask_ratio_h is not None or self.mask_ratio_h > 0:
            drop |= select_drop_mask(
                score(ta, mrh, True), mask, mrh, largest=True,
                noise=mask_u[1],
                random_frac=self.mask_ratio_hr if self.mask_ratio_hr > 0
                else 1.0)
        return drop

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                teacher_attn: Optional[torch.Tensor] = None,
                mask_ratio_h=None, return_attn: bool = False,
                generator: Optional[torch.Generator] = None,
                mask_u: Optional[torch.Tensor] = None):
        b, n, _ = feats.shape
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=feats.device)
        h = _act(self.act)(self.patch_to_emb[0](feats.to(_F32)))
        if not deterministic and self.droprate > 0:
            h = dropout(h, self.droprate, generator)
        keep = mask
        if not deterministic and (self.mask_ratio > 0
                                  or teacher_attn is not None):
            keep = mask & ~self._drop(mask, teacher_attn, mask_ratio_h,
                                      mask_u, generator)
        out = self.online_encoder(h, keep, deterministic,
                                  return_attn=return_attn, generator=generator)
        cls_feat, attns = out if return_attn else (out, None)
        result = {"logits": self.predictor(cls_feat), "cls_feat": cls_feat,
                  "keep": keep}
        if return_attn:
            result["attn"] = attns[self.attn_layer if self.attn_layer >= 0
                                   else -1]
        return result

    @torch.no_grad()
    def forward_teacher(self, feats, mask=None):
        """The teacher pass: no masking, with the attention
        (`modules/mhim.py:190-202`)."""
        return self(feats, mask, deterministic=True, return_attn=True)


def soft_target_ce(student: torch.Tensor, teacher: torch.Tensor,
                   temp_t: float = 1.0, temp_s: float = 1.0) -> torch.Tensor:
    """``SoftTargetCrossEntropy_v2`` (`modules/mhim.py:20-33`)."""
    t = torch.softmax(teacher / temp_t, dim=-1)
    ls = torch.log_softmax(student / temp_s, dim=-1)
    return torch.mean(torch.sum(-t * ls, dim=-1))
