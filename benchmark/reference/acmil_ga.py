"""Plain reference of the ACMIL_GA head (Zhang et al., "Attention-
Challenging Multiple Instance Learning for Whole Slide Image
Classification", ECCV 2024; `architecture/transformer.py:291-354` and
`Step3_WSI_classification_ACMIL.py:199-216` of its code): one bag at a
time on its valid patches, in f32 with TF32 off, autograd for the
gradients and AdamW written out. It imports nothing of the program.

Forward on a bag ``x [n, D_feat]``: ``h = relu(x W1^T)``; gated attention
``a = (tanh(h V^T + bv) * sigmoid(h U^T + bu)) Ww^T + bw`` ``[K, n]``;
in training STKIM drops, in each branch, ``floor(min(k, n) * mask_drop)`` of
the top ``k = n_masked_patch`` logits, those with the smallest uniforms of
the step's draw; ``p = softmax(a)``; branch features ``p h``; branch logits
by each branch's classifier; the slide logit from the branch-mean
attention. Loss: branch CE (mean over branches) + slide CE + the mean
pairwise cosine similarity of the branches' attention maps.

Every product goes through :func:`mm`, whose operands (forward and
backward) are rounded to ``prec``: ``f32`` is the reference, ``tf32`` its
control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from harness.precision import ROUND, exact_f32

BETAS, EPS = (0.9, 0.999), 1e-8


class _MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        r = ROUND[prec]
        a, b = r(a), r(b)
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = ROUND[ctx.prec](g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g, None


def mm(a, b, prec: str):
    return _MM.apply(a, b, prec)


def _cls_names(params: Dict[str, torch.Tensor], k: int):
    return [(params[f"classifier.{i}.fc.weight"],
             params[f"classifier.{i}.fc.bias"]) for i in range(k)]


def stkim_drop(a: torch.Tensor, u: torch.Tensor, n_masked: int,
               mask_drop: float) -> torch.Tensor:
    """[K, n] bool: the dropped logits."""
    n = a.shape[1]
    k = min(n_masked, n)
    n_drop = int(math.floor(k * mask_drop))
    drop = torch.zeros_like(a, dtype=torch.bool)
    if n_drop == 0:
        return drop
    top = torch.topk(a.detach(), k, dim=1).indices               # [K, k]
    ut = torch.gather(u, 1, top)
    lowest = torch.topk(-ut, n_drop, dim=1).indices               # [K, d]
    drop.scatter_(1, torch.gather(top, 1, lowest), True)
    return drop


def forward(params, x, conf, prec: str, u=None):
    """(branch logits [K, C], slide logits [C], attention logits [K, n]
    after STKIM)."""
    x = x.float()
    h = torch.relu(mm(x, params["dimreduction.fc1.weight"].t(), prec))
    v = torch.tanh(mm(h, params["attention.attention_V.0.weight"].t(), prec)
                   + params["attention.attention_V.0.bias"])
    g = torch.sigmoid(mm(h, params["attention.attention_U.0.weight"].t(),
                         prec) + params["attention.attention_U.0.bias"])
    a = (mm(v * g, params["attention.attention_weights.weight"].t(), prec)
         + params["attention.attention_weights.bias"]).t()        # [K, n]
    if u is not None:
        drop = stkim_drop(a, u, conf["n_masked_patch"], conf["mask_drop"])
        a = a.masked_fill(drop, -math.inf)
    p = torch.softmax(a, dim=1)
    bag = mm(p, h, prec)                                          # [K, L]
    k = a.shape[0]
    sub = torch.stack([mm(bag[i:i + 1], w.t(), prec)[0] + b
                       for i, (w, b) in enumerate(_cls_names(params, k))])
    slide = (mm(mm(p.mean(dim=0, keepdim=True), h, prec),
                params["Slide_classifier.fc.weight"].t(), prec)[0]
             + params["Slide_classifier.fc.bias"])
    return sub, slide, a


def loss(sub, slide, a, label: int, prec: str):
    k = sub.shape[0]
    target = torch.full((k,), label, dtype=torch.long, device=sub.device)
    l_sub = torch.nn.functional.cross_entropy(sub, target)
    l_slide = torch.nn.functional.cross_entropy(
        slide[None], target[:1])
    p = torch.softmax(a, dim=1)
    pn = p / torch.linalg.vector_norm(p, dim=1, keepdim=True).clamp_min(1e-12)
    sim = mm(pn, pn.t(), prec)
    iu = torch.triu(torch.ones(k, k, dtype=torch.bool, device=a.device), 1)
    div = sim[iu].sum() / (k * (k - 1) / 2)
    return l_sub + l_slide + div


def half_cosine(conf, step: int) -> float:
    """The learning rate at optimizer step ``step`` (from 0): linear warm-up,
    then a half cosine to ``min_lr``, the epoch fractional per step
    (the reference's ``adjust_learning_rate``), rounded to f32."""
    epoch = step / conf["steps_per_epoch"]
    lr, lo, warm = conf["lr"], conf["min_lr"], conf["warmup_epoch"]
    if epoch < warm:
        rate = lr * epoch / warm
    else:
        rate = lo + (lr - lo) * 0.5 * (1.0 + math.cos(
            math.pi * (epoch - warm) / max(conf["train_epoch"] - warm, 1e-8)))
    return float(torch.tensor(rate, dtype=torch.float32))


def three_steps(init: Dict[str, torch.Tensor], bags: List[tuple], conf,
                stkim_seed: int, device, prec: str = "f32"
                ) -> Tuple[List[float], Dict[str, torch.Tensor],
                           Dict[str, torch.Tensor]]:
    """AdamW steps from ``init``, one bag ``(x [n, D], label, bucket)``
    each; STKIM's uniforms drawn ``[1, K, bucket]`` a step from a generator
    seeded ``stkim_seed`` on ``device``, the first ``n`` of each row used.
    Returns each step's loss, the first step's gradient and the change of
    every parameter after the last step."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(stkim_seed)
    k_tok = params["attention.attention_weights.weight"].shape[0]
    losses, grad1 = [], None
    with exact_f32():
        for t, (x, label, b) in enumerate(bags, 1):
            u = torch.rand((1, k_tok, b), generator=gen, device=device)
            sub, slide, a = forward(params, x, conf, prec,
                                    u[0, :, :x.shape[0]])
            val = loss(sub, slide, a, label, prec)
            grads = torch.autograd.grad(val, list(params.values()))
            losses.append(float(val.detach()))
            if t == 1:
                grad1 = {k: g.detach().clone()
                         for k, g in zip(params, grads)}
            lr = half_cosine(conf, t - 1)
            bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    p.mul_(1 - lr * conf["wd"])
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    s[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    denom = s[k].sqrt() / math.sqrt(bc2) + EPS
                    p.addcdiv_(m[k], denom, value=-lr / bc1)
    change = {k: (p.detach() - init[k].float()) for k, p in params.items()}
    return losses, grad1, change


def eval_probs(init: Dict[str, torch.Tensor], bags: List[torch.Tensor],
               conf, prec: str = "f32") -> torch.Tensor:
    """Slide probabilities ``[len(bags), C]`` at ``init``, no STKIM."""
    out = []
    with torch.no_grad(), exact_f32():
        for x in bags:
            _, slide, _ = forward(init, x, conf, prec)
            out.append(torch.softmax(slide, dim=0))
    return torch.stack(out)
