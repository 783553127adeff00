"""Serving paths through kernel B1, the port of ``acmil_tpu/models/fast.py``.

They take the same modules as the plain forwards (``models/acmil.py``), so a
trained checkpoint serves through the kernel with no conversion. The pooling
runs :func:`acmil_tpu_torch.ops.attn_pool.fused_gated_attn_pool_batched`;
the branch and slide classifiers after it stay plain PyTorch, as the JAX
package leaves them to XLA. The DimReduction is bias-free, so the kernel's
``b1`` is zero.

Eval forms only: a STKIM generator (training) raises until the training
slice brings kernel B2 and ``stkim_drop``.
"""

from __future__ import annotations

import torch

from acmil_tpu_torch.ops.attn_pool import (fused_gated_attn_pool,
                                           fused_gated_attn_pool_batched)


def _ga_weights(model):
    """The kernel's operands from a GA-structured module, in the JAX
    layout: W1 [Df, L], zero b1 [L], V/U [L, A], bv/bu [A], w [A, K], bw [K]."""
    w1 = model.dimreduction.fc1.weight.t()
    att = model.attention
    v, u = att.attention_V[0], att.attention_U[0]
    return (w1, torch.zeros(w1.shape[1], device=w1.device, dtype=w1.dtype),
            v.weight.t(), v.bias, u.weight.t(), u.bias,
            att.attention_weights.weight.t(), att.attention_weights.bias)


def _branch_heads(model, bag):
    """Per-branch classifiers on ``bag [..., K, L]`` → ``[..., K, C]``."""
    w = torch.stack([h.fc.weight for h in model.classifier])   # [K, C, L]
    b = torch.stack([h.fc.bias for h in model.classifier])     # [K, C]
    return torch.einsum("...kl,kcl->...kc", bag, w) + b


def acmil_ga_infer(model, feats, mask):
    """ACMIL_GA deterministic forward for one bag: feats ``[N, D_feat]``,
    mask ``[N]`` bool → (sub_preds [K, C], slide_preds [C],
    attn_logits [K, N]), matching ``ACMIL_GA.forward`` on a batch of one."""
    bag, logits = fused_gated_attn_pool(feats, mask, *_ga_weights(model))
    sub = _branch_heads(model, bag)
    # slide classifier on the branch-mean bag feature: mean-of-softmax
    # attention pooling == mean of per-branch pooled features
    slide = model.Slide_classifier.fc(bag.mean(dim=0))
    return sub, slide, logits


def abmil_infer(model, feats, mask):
    """ABMIL deterministic forward for one bag (K=1) → (logits [C],
    attn_logits [1, N])."""
    bag, logits = fused_gated_attn_pool(feats, mask, *_ga_weights(model))
    return model.classifier.fc(bag[0]), logits


def acmil_ga_apply_batched(model, feats, mask, stkim_generator=None):
    """ACMIL_GA eval forward, batched: feats ``[B, N, D_feat]`` (fp16 or
    f32), mask ``[B, N]`` → (sub [B, K, C], slide [B, C], logits [B, K, N]).

    Matches ``ACMIL_GA.forward(deterministic=True)`` on the same module; the
    pooling runs kernel B1 on CUDA tensors. Logits hold ``NEG`` (-1e30) at
    pad slots, where the plain forward keeps raw values.
    """
    if stkim_generator is not None:
        raise NotImplementedError(
            "STKIM in the fused route comes with the training slice "
            "(kernel B2 and stkim_drop)")
    bag, logits = fused_gated_attn_pool_batched(feats, mask,
                                                *_ga_weights(model))
    sub = _branch_heads(model, bag)
    slide = model.Slide_classifier.fc(bag.mean(dim=1))
    return sub, slide, logits
