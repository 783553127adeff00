"""DTFD-MIL, two-tier pseudo-bag MIL with instance distillation, the port
of ``acmil_tpu/models/dtfd.py``.

Reference: `Step3_WSI_classification_DTFD.py:61-160` (the training loop),
`architecture/Attention.py` (`Attention_Gated:29`,
`Attention_with_Classifier:62`), the CAM trick `utils/utils.py:48`.

Per slide: split the bag at random into ``num_group`` pseudo-bags; tier 1
pools each with gated attention and classifies it; each group's instances
are distilled by their CAM probability (MaxMinS: the top-k and bottom-k
features, MaxS: the top-k, AFS: the attention-pooled feature); tier 2 is a
gated-attention classifier over the distilled features, which it takes
detached, so tier-1 weights learn from the tier-1 loss alone.

The split is an argsort of uniforms ``u [B, N]`` (stable, as ``jnp.argsort``)
reshaped to ``[B, G, N/G]``: pad slots ride along masked. In training the
uniforms come from ``group_u`` or ``generator``; in eval they are the JAX
package's own, ``jax.random.uniform(PRNGKey(0), (B, N))``
(:func:`acmil_tpu_torch.ops.prng.eval_uniforms`), so both packages group
every eval bag alike.

Module names are the reference's (``dimReduction``, ``attention``,
``classifier``, ``UClassifier``), so a reference checkpoint loads as it is
and the four per-module clip groups are the four children. Every Linear
takes torch's default init, drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from acmil_tpu_torch.models.common import (AttentionGated, Classifier1fc,
                                           DimReduction, dropout,
                                           torch_linear_init_)
from acmil_tpu_torch.ops.masked import masked_fill, masked_softmax
from acmil_tpu_torch.ops.prng import eval_uniforms

DISTILL_MODES = ("MaxMinS", "MaxS", "AFS")


def group_uniforms(shape: Tuple[int, int], device, deterministic: bool,
                   group_u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The uniforms ``[B, N]`` the grouping sorts: ``group_u`` when given,
    else the JAX eval draws when ``deterministic``, else fresh ones from
    ``generator``."""
    if group_u is not None:
        return group_u.to(device)
    if deterministic:
        return eval_uniforms(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def group_permutation(u: torch.Tensor, mask: torch.Tensor, num_group: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniforms and mask ``[B, N]`` → each group's member indices
    ``[B, G, N/G]`` and their validity."""
    b, n = mask.shape
    if n % num_group:
        raise ValueError(f"the bag length {n} is not a multiple of "
                         f"numGroup {num_group}")
    perm = torch.argsort(u, dim=-1, stable=True)
    gmask = torch.gather(mask, 1, perm)
    s = n // num_group
    return perm.reshape(b, num_group, s), gmask.reshape(b, num_group, s)


def gather_groups(mid: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """``mid [B, N, L]`` at ``groups [B, G, S]`` → ``[B, G, S, L]``, one
    gather (no copy of the bag per group)."""
    rows = torch.arange(mid.shape[0], device=mid.device)[:, None, None]
    return mid[rows, groups]


def first_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


class AttentionWithClassifier(nn.Module):
    """Tier 2 (`Attention.py:62`): gated attention over the distilled
    features, then a one-linear classifier with dropout."""

    def __init__(self, L: int, D: int, n_class: int, droprate: float = 0.0):
        super().__init__()
        self.droprate = droprate
        self.attention = AttentionGated(L, D, 1)
        self.classifier = Classifier1fc(L, n_class, 0.0)

    def forward(self, x, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        a = self.attention(x)                                    # [B, 1, M]
        attn = masked_softmax(a, mask[:, None, :])
        feat = (attn @ x)[:, 0]                                  # [B, L]
        if not deterministic and self.droprate > 0:
            feat = dropout(feat, self.droprate, generator)
        return self.classifier(feat)


class DTFD(nn.Module):
    """Both tiers in one module. ``forward`` returns the JAX module's dict:
    ``logits [B, C]`` (tier 2), ``sub_preds [B, G, C]`` (tier 1),
    ``group_valid [B, G]`` and ``attn [B, G, S]`` (the tier-1 attention
    logits, ``NEG_INF`` at pad slots)."""

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 d_attn: int = 128, num_group: int = 4,
                 instance_per_group: int = 1, distill: str = "MaxMinS",
                 droprate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if distill not in DISTILL_MODES:
            raise ValueError(f"distill must be one of {DISTILL_MODES}, "
                             f"got {distill!r}")
        self.num_group = num_group
        self.instance_per_group = instance_per_group
        self.distill = distill
        self.dimReduction = DimReduction(d_feat, d_inner)
        self.attention = AttentionGated(d_inner, d_attn, 1)
        self.classifier = Classifier1fc(d_inner, n_class, 0.0)
        self.UClassifier = AttentionWithClassifier(d_inner, d_attn, n_class,
                                                   droprate)
        torch_linear_init_(self, generator)

    def reduce(self, feats: torch.Tensor) -> torch.Tensor:
        """``relu(feats @ W1)`` in the weights' dtype."""
        return self.dimReduction(feats.to(self.dimReduction.fc1.weight.dtype))

    def pseudo_bags(self, feats, mask=None, deterministic: bool = True,
                    group_u: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reduced features of each pseudo-bag ``[B, G, S, L]`` and
        their validity ``[B, G, S]``; ``group_u`` as in :func:`group_uniforms`."""
        b, n, _ = feats.shape
        if mask is None:
            mask = torch.ones(b, n, dtype=torch.bool, device=feats.device)
        u = group_uniforms((b, n), feats.device, deterministic, group_u,
                           generator)
        groups, gmask = group_permutation(u, mask, self.num_group)
        return gather_groups(self.reduce(feats), groups), gmask

    def forward(self, feats, mask=None, deterministic: bool = True,
                group_u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``group_u [B, N]``: the grouping's uniforms (see
        :func:`group_uniforms`); ``generator`` also draws tier 2's
        dropout."""
        gfeat, gmask = self.pseudo_bags(feats, mask, deterministic, group_u,
                                        generator)
        b, g, s, _ = gfeat.shape
        a = self.attention(gfeat.reshape(b * g, s, -1)).reshape(b, g, s)
        attn = masked_softmax(a, gmask)
        pooled = (gfeat * attn[..., None]).sum(dim=2)            # [B, G, L]
        return self.tiers(gfeat, gmask, a, attn, pooled, deterministic,
                          generator)

    def tiers(self, gfeat, gmask, a, attn, pooled, deterministic: bool = True,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """Everything after the tier-1 pooling, shared by the plain forward
        and the kernels' route (``models/fast.py::dtfd_apply_fused``):
        gfeat ``[B, G, S, L]``, gmask and the logits ``a`` and attention
        ``attn`` ``[B, G, S]``, pooled ``[B, G, L]``."""
        b, g, s, _ = gfeat.shape
        fc = self.classifier.fc
        sub_preds = fc(pooled)                                   # [B, G, C]
        # CAM per-patch logits: the attention-weighted features times the
        # classifier weight, no bias (get_cam_1d, utils.py:48)
        cam = (gfeat * attn[..., None]) @ fc.weight.t()          # [B,G,S,C]
        patch_prob = torch.softmax(cam, dim=-1)[..., -1]         # [B, G, S]

        k = min(self.instance_per_group, s)
        top_idx = first_k(masked_fill(patch_prob, gmask), k)     # [B, G, k]
        if self.distill == "AFS":
            d_feat, d_mask = pooled, gmask.any(dim=-1)
        else:
            idx = top_idx
            if self.distill == "MaxMinS":
                bot_idx = first_k(masked_fill(-patch_prob, gmask), k)
                idx = torch.cat([top_idx, bot_idx], dim=-1)
            m = idx.shape[-1]
            d_feat = torch.gather(
                gfeat, 2, idx[..., None].expand(-1, -1, -1, gfeat.shape[-1])
            ).reshape(b, g * m, -1)
            d_mask = torch.gather(gmask, 2, idx).reshape(b, g * m)
        logits = self.UClassifier(d_feat.detach(), d_mask, deterministic,
                                  generator)
        return {"logits": logits, "sub_preds": sub_preds,
                "group_valid": gmask.any(dim=-1),
                "attn": masked_fill(a, gmask)}
