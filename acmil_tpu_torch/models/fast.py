"""Fused paths through kernels B1, B2 and B6, the port of
``acmil_tpu/models/fast.py``.

They take the same modules as the plain forwards (``models/acmil.py``,
``models/dsmil.py``), so a trained checkpoint serves through the kernels with
no conversion. The ACMIL pooling runs
:func:`acmil_tpu_torch.ops.attn_pool.gated_attn_pool_grad` (B1 forward, B2
backward); the branch and slide classifiers after it stay plain PyTorch, as
the JAX package leaves them to XLA. The DimReduction is bias-free, so the
kernels' ``b1`` is zero. CLAM_SB pools through the same pair, its fc bias as
``b1``, and CLAM_MB through their softmax-one wrapper
(:func:`clam_apply_fused`). DSMIL's eval forward pools through B6
(:func:`dsmil_eval_fused`). DTFD pools each pseudo-bag through B1 and B2
with an identity first layer over the dim-reduced features
(:func:`dtfd_apply_fused`), when ``DTFD_FUSE_MIN_S`` lets it.

In training, STKIM applies to the pooled output as an O(K·k) correction
(:func:`_stkim_correct`), so the recipe with STKIM keeps the fused kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from acmil_tpu_torch.models.clam import _CLAMBase, _instance_loss
from acmil_tpu_torch.models.dsmil import DSMIL
from acmil_tpu_torch.models.dtfd import DTFD
from acmil_tpu_torch.ops.attn_pool import (fused_gated_attn_pool,
                                           gated_attn_pool_grad,
                                           gated_attn_pool_grad_one,
                                           sharded_gated_attn_pool_grad)
from acmil_tpu_torch.ops.dsmil_pool import fused_dsmil_pool
from acmil_tpu_torch.ops.masked import (NEG_INF, masked_fill, masked_max,
                                        masked_softmax, stkim_drop)
from acmil_tpu_torch.parallel import collectives as C

# The DSMIL families route eval through B6 only at N ≥ this threshold,
# copied verbatim from the JAX package (acmil_tpu/models/fast.py), so the
# port sends the same bags to the kernel. It is that package's fused-vs-plain
# crossover on its TPU, not a measurement of the H100's (chip_smoke.py times
# both routes there). Tests pin it to 0 to force the kernel at small N.
FUSE_MIN_N = 49152

# The DTFD family routes through B1/B2 only at a per-group length N / numGroup
# of at least this; None never routes. The JAX package keeps None (its fused
# route measured 0.89-0.94x of XLA on its TPU); chip_smoke.py phase 20 times
# both routes on the H100 at 50000 patches. Tests pin it to 0.
DTFD_FUSE_MIN_S = None

# Smallest kept softmax mass (1 − Σ dropped probabilities) the O(K·k)
# STKIM subtract-renormalise identity stays accurate for in f32:
# relative error ≈ ε / kept_mass ≈ 6e-8 / 1e-5 ≈ 6e-3. Below it the
# correction switches to an exact kept-softmax recompute.
_STKIM_KEPT_MIN = 1e-5


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


def _stkim_correct(bag, logits, feats, mask, w1, n_masked_patch: int,
                   mask_drop: float, u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, mesh=None,
                   on_device: bool = False):
    """Apply STKIM to an already-pooled bag as an O(K·k) correction.

    The kernel pools with the full softmax and emits the raw logits
    ``[B, K, N]``. STKIM drops a random subset of each branch's top-k
    logits, so the post-drop pooled feature is the full one minus the
    dropped terms, renormalised:

        bag' = (bag − Σ_dropped p_t h_t) / (1 − Σ_dropped p_t)

    with ``p_t`` the full-softmax probabilities of the dropped entries:
    one logsumexp over the logits, then a gather of ≤k rows per branch and
    their recomputed ``h``.

    The subtraction cancels in f32 when the dropped entries carry almost
    all the mass, so below ``_STKIM_KEPT_MIN`` kept mass the whole batch
    takes an exact kept-softmax recompute instead. The JAX package decides
    this on the device (``lax.cond``); here the branch reads one element
    back to the host, one sync per step. With ``on_device`` (the scanned
    step, which a CUDA graph holds) both branches are computed and
    ``torch.where`` keeps the one the host would have taken, with its very
    numbers: the cost is the exact branch's dim-reduction GEMM over every
    patch, ``[B, N, Df] x [Df, L]``, each step.

    On a ``mesh`` with a seq axis, ``logits`` and ``mask`` are the whole
    bag's (gathered) and ``feats`` this rank's slice of N: the top-k runs
    over the whole bag, each rank adds the terms of its own rows, and a
    psum over the seq group joins them. Every rank of the world takes the
    branch of the world's least kept mass, as the JAX ``lax.cond`` takes
    the branch of the global batch's: the least is MIN-reduced over the
    world group, then read on the host (the per-bag step) or kept on the
    device for the ``torch.where`` (``on_device``, the scanned step; on
    ``gloo`` the reduction itself stages through the host, so only an
    NCCL world of one runs that step in a CUDA graph).

    Returns (bag' [B, K, L], post-drop logits [B, K, N] with NEG_INF at
    dropped positions).
    """
    drop, topk_idx = stkim_drop(logits, n_masked_patch, mask_drop,
                                mask[:, None, :], u, generator)
    if drop is None:
        return bag, logits
    group = mesh.seq_group if mesh is not None else None
    n_loc = feats.shape[1]
    off = mesh.seq_index * n_loc if group is not None else 0
    w1 = C.fan_out(w1, group)
    a_drop = torch.where(drop, NEG_INF, logits)
    lse_full = torch.logsumexp(torch.where(mask[:, None, :], logits, NEG_INF),
                               dim=-1, keepdim=True)
    dflag = torch.gather(drop, -1, topk_idx)                  # [B, K, k]
    a_top = torch.gather(logits, -1, topk_idx)
    p_top = torch.exp(a_top - lse_full) * dflag.to(logits.dtype)
    kept_mass = 1.0 - p_top.sum(dim=-1)                       # [B, K]

    least = kept_mass.detach().min()

    def subtract():
        # subtract the dropped terms: gather ≤k rows per branch (this
        # rank's), recompute h
        local = topk_idx - off
        own = (local >= 0) & (local < n_loc)
        rows = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
        x_top = feats[rows, local.clamp(0, n_loc - 1)]        # [B, K, k, Df]
        h_top = torch.relu(x_top.to(w1.dtype) @ w1)           # [B, K, k, L]
        terms = torch.einsum("bkt,bktl->bkl",
                             C.fan_out(p_top, group) * own.to(p_top.dtype),
                             h_top)
        num = bag - C.psum(terms, group)
        return num / kept_mass[..., None].clamp_min(_STKIM_KEPT_MIN / 4)

    def exact():
        # kept-softmax pooling from scratch: exact, at the cost of the
        # dim-reduction GEMM over every patch
        h = torch.relu(feats.to(w1.dtype) @ w1)               # [B, n, L]
        keep = mask[:, None, :] & ~drop
        attn = torch.softmax(torch.where(keep, a_drop, NEG_INF), dim=-1)
        attn = C.group_slice(C.fan_out(attn, group), group, 2)
        return C.psum(torch.einsum("bkn,bnl->bkl", attn, h), group)

    if mesh is not None:
        least = C.all_reduce_(least.clone(), mesh.world_group, C.ReduceOp.MIN)
    if on_device:
        return torch.where(least >= _STKIM_KEPT_MIN, subtract(), exact()), \
            a_drop
    if float(least) >= _STKIM_KEPT_MIN:
        return subtract(), a_drop
    return exact(), a_drop


def acmil_ga_apply_batched(model, feats, mask,
                           stkim_u: Optional[torch.Tensor] = None,
                           stkim_generator: Optional[torch.Generator] = None,
                           n_masked_patch: int = 0, mask_drop: float = 0.0,
                           mesh=None, stkim_on_device: bool = False):
    """Differentiable fused ACMIL_GA forward, batched: feats
    ``[B, N, D_feat]`` (fp16 or f32), mask ``[B, N]`` → (sub [B, K, C],
    slide [B, C], logits [B, K, N]).

    Matches ``ACMIL_GA.forward`` on the same module. The pooling runs kernel
    B1 on CUDA tensors and its backward kernel B2; the features get no
    gradient unless they require one. With ``n_masked_patch`` and
    ``mask_drop`` > 0 and STKIM's uniforms given (``stkim_u [B, K, N]``) or
    a generator to draw them, STKIM applies as :func:`_stkim_correct`;
    without either it is off, as in eval. ``stkim_on_device`` decides its
    correction branch on the device (the scanned step's). Logits hold
    ``NEG`` (-1e30) at pad slots, where the plain forward keeps raw values.

    With a ``mesh`` whose seq axis is above 1, ``feats`` and ``mask`` are
    this rank's slice of N: the pooling runs
    ``ops/attn_pool.py::sharded_gated_attn_pool_grad`` (B1 and B2 on the
    slice, the flash merge across the seq group), and the logits come back
    gathered over the whole bag, ``[B, K, N_pad]``, as the loss reads them.
    """
    w1, *rest = _ga_weights(model)
    group = mesh.seq_group if mesh is not None else None
    if group is None:
        bag, logits = gated_attn_pool_grad(feats, mask, w1, *rest)
    else:
        bag, logits = sharded_gated_attn_pool_grad(feats, mask, w1, *rest,
                                                   group)
        logits = C.all_gather(logits, group, dim=2)
        mask = torch.cat(C.gather_list(mask, group), dim=1)
    stkim = stkim_u is not None or stkim_generator is not None
    if stkim and n_masked_patch > 0 and mask_drop > 0:
        bag, logits = _stkim_correct(bag, logits, feats, mask, w1,
                                     n_masked_patch, mask_drop, stkim_u,
                                     stkim_generator, mesh, stkim_on_device)
    sub = _branch_heads(model, bag)
    slide = model.Slide_classifier.fc(bag.mean(dim=1))
    return sub, slide, logits


def _clam_weights(model):
    """The kernels' operands from a CLAM module, in the JAX layout: the fc
    (with its bias as ``b1``) and ``Attn_Net_Gated``, the same gated
    attention the kernels compute (`architecture/clam.py:46-67`)."""
    fc, ag = model.attention_net[0], model.attention_net[-1]
    return (fc.weight.t(), fc.bias,
            ag.attention_a[0].weight.t(), ag.attention_a[0].bias,
            ag.attention_b[0].weight.t(), ag.attention_b[0].bias,
            ag.attention_c.weight.t(), ag.attention_c.bias)


def clam_is_fusable(model) -> bool:
    """True for a CLAM module with the gated attention net."""
    return isinstance(model, _CLAMBase) and model.gate


def _clam_instance_loss(model, feats, mask, label, A, w1, b1, *,
                        n_class: int, k_sample: int, subtyping: bool):
    """``clam._instance_loss`` on the kernels' outputs: top/bottom-k over the
    attention rows, with h recomputed only for the ≤ 2k gathered rows of
    each class instead of the whole ``[B, N, L]``: a plain ``torch.matmul``
    in f32 (TF32 stays as torch's default leaves it, off). CE only: the
    SVM instance loss keeps the plain forward."""
    rows = torch.arange(feats.shape[0], device=feats.device)[:, None]

    def gather_h(idx):                                   # [B, k] -> [B, k, L]
        return torch.relu(feats[rows, idx].to(w1.dtype) @ w1 + b1)

    inst_w, inst_b = model.instance_weights()
    return _instance_loss(A, gather_h, mask, label, inst_w, inst_b,
                          n_class=n_class, k_sample=k_sample,
                          subtyping=subtyping,
                          multi_branch=model.multi_branch)


def clam_apply_fused(model, feats, mask, label=None,
                     instance_eval: bool = False, *, n_class: int,
                     k_sample: int = 8, subtyping: bool = False):
    """CLAM_SB/MB's forward through kernels B1 and B2 (eval always; training
    when dropout is off), matching ``CLAM_SB/CLAM_MB.forward`` on the same
    module: SB pools with :func:`gated_attn_pool_grad`, MB with
    :func:`gated_attn_pool_grad_one` (softmax-one). ``attn`` is the raw
    attention logits at valid slots, ``NEG`` at pad slots. With
    ``instance_eval`` the instance loss gathers ≤ 2·k_sample rows per class
    and recomputes their h (:func:`_clam_instance_loss`)."""
    w1, b1, *rest = _clam_weights(model)
    pool = (gated_attn_pool_grad_one if model.multi_branch
            else gated_attn_pool_grad)
    M, logits_a = pool(feats, mask, w1, b1, *rest)
    out = {"logits": model.bag_logits(M), "attn": logits_a, "bag_feat": M}
    if instance_eval:
        A = model.normalize(logits_a, mask)
        out["instance_loss"] = _clam_instance_loss(
            model, feats, mask, label, A, w1, b1, n_class=n_class,
            k_sample=k_sample, subtyping=subtyping)
    return out


def dsmil_is_fusable(model) -> bool:
    """True for the generic trainer's DSMIL build (``nonlinear=False``,
    ``passing_v=False``, `Step3_WSI_classification.py:129-131`); the
    nonlinear and passing_v variants keep the plain forward."""
    return (isinstance(model, DSMIL) and not model.nonlinear
            and not model.passing_v)


def dsmil_eval_fused(model, feats, mask):
    """DSMIL's deterministic forward through kernel B6 → the family's eval
    pair (masked-max instance logits [B, C], bag logits [B, C]), matching
    ``DSMIL.forward``.

    The instance GEMM, the critical-instance argmax and ``q_max`` run as
    plain PyTorch on an f32 copy of the features, as the JAX function runs
    them in XLA; B6 then pools the features as they came (fp16 or f32)."""
    inst_fc = model.i_classifier.fc[0]
    q_fc = model.b_classifier.q
    x = feats.to(inst_fc.weight.dtype)
    inst = F.linear(x, inst_fc.weight, inst_fc.bias)            # [B, N, C]
    crit = masked_fill(inst, mask[:, :, None]).argmax(dim=1)    # [B, C]
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    q_max = F.linear(x[rows, crit], q_fc.weight, q_fc.bias)     # [B, C, Q]
    bag_feat, _ = fused_dsmil_pool(feats, mask, q_fc.weight.t(), q_fc.bias,
                                   q_max)
    fcc = model.b_classifier.fcc
    bag_logits = F.linear(bag_feat.reshape(x.shape[0], -1),
                          fcc.weight.reshape(fcc.out_channels, -1), fcc.bias)
    return masked_max(inst, mask, dim=1), bag_logits


def dtfd_apply_fused(model: DTFD, feats, mask, deterministic: bool = True,
                     group_u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """DTFD's forward with the tier-1 pooling on kernels B1 and B2, matching
    ``DTFD.forward`` on the same module and uniforms.

    ``mid = relu(feats @ W1)`` is computed once (the CAM and the distilled
    gathers need it anyway) and gathered per group, and the pooling runs on
    ``[B·G, S, L]`` with the kernels' first layer the identity and ``b1``
    zero: relu is idempotent on the rectified ``mid``, so the kernels' H is
    ``mid`` itself. B1 runs once a call and B2 once a backward (with the
    features' gradient, which ``mid`` needs)."""
    gfeat, gmask = model.pseudo_bags(feats, mask, deterministic, group_u,
                                     generator)              # [B, G, S, L]
    b, g, s, ldim = gfeat.shape
    eye = torch.eye(ldim, dtype=gfeat.dtype, device=gfeat.device)
    zb = torch.zeros(ldim, dtype=gfeat.dtype, device=gfeat.device)
    att = model.attention
    v, uu = att.attention_V[0], att.attention_U[0]
    bag, logits = gated_attn_pool_grad(
        gfeat.reshape(b * g, s, ldim), gmask.reshape(b * g, s), eye, zb,
        v.weight.t(), v.bias, uu.weight.t(), uu.bias,
        att.attention_weights.weight.t(), att.attention_weights.bias)
    a = logits.reshape(b, g, s)
    return model.tiers(gfeat, gmask, a, masked_softmax(a, gmask),
                       bag.reshape(b, g, ldim), deterministic, generator)
