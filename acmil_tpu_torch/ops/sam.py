"""SAM, sharpness-aware minimisation, the port of ``acmil_tpu/ops/sam.py``.

Reference: `utils/utils.py:425-484` (``SAM.first_step``/``second_step``).
The gradient at the loss-ascent point ``p + ε``, ``ε = ρ g / ||g||``
(adaptive: ``ε = ρ p² g / ||p g||``), which the base optimizer then steps
with: two gradient passes a step.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """d loss / d params, zeros where the loss does not reach a parameter
    (as ``jax.grad`` gives them)."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    # in each parameter's own layout, as .backward() accumulates them: a
    # gradient through a transposed view comes back transposed, which a
    # fused optimizer refuses
    return [torch.zeros_like(p) if g is None
            else g if g.stride() == p.stride()
            else torch.empty_like(p).copy_(g)
            for p, g in zip(params, gs)]


def _norm(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in ts]))


def sam_gradient(loss_fn: Callable[[], Tuple[torch.Tensor, dict]],
                 params: Sequence[torch.Tensor], rho: float = 0.05,
                 adaptive: bool = False
                 ) -> Tuple[Tuple[torch.Tensor, dict], List[torch.Tensor]]:
    """``loss_fn()`` → ``(loss, aux)`` at the parameters' current values.
    Returns ``((loss, aux), sam_grads)``: the loss and ``aux`` of the first
    pass, detached, and the gradient at the perturbed point. ``loss_fn``
    must make the same random draws on each call; the parameters come back
    from a saved copy, bit for bit, whatever ``p + ε - ε`` would round
    to."""
    loss, aux = loss_fn()
    grads = _grads(loss, params)
    with torch.no_grad():
        if adaptive:
            norm = _norm([p.abs() * g for p, g in zip(params, grads)])
            eps = [rho * p * p * g / (norm + 1e-12)
                   for p, g in zip(params, grads)]
        else:
            norm = _norm(grads)
            eps = [rho * g / (norm + 1e-12) for g in grads]
        saved = [p.detach().clone() for p in params]
        for p, e in zip(params, eps):
            p.add_(e)
    try:
        loss2, _ = loss_fn()
        sam_grads = _grads(loss2, params)
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), sam_grads
