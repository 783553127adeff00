"""Masked Nystrom attention, landmark-based O(N·m) attention: the port of
``acmil_tpu/ops/nystrom.py`` (``newton_schulz_pinv``, ``nystrom_attention``
and ``depthwise_seq_conv``).

Reference: `architecture/nystrom_attention.py:30-149` (vendored
nystrom-attention 0.0.12). The sequence is sum-reduced into ``m`` landmark
groups; three softmax similarity matrices (q·kL, qL·kL, qL·k) are built, the
middle one is inverted by six Newton–Schulz iterations, and the output is
``attn1 @ pinv(attn2) @ (attn3 @ v)``, plus a depthwise conv residual over
the values in the module that calls it.

Masking is the JAX package's, not the reference's (whose masked branch is
dead code): masked q/k/v are zeroed so landmark sums see only valid rows,
landmark means divide by the per-group valid count (+ 1e-8), logits to or
from invalid landmarks or positions are -1e9, invalid queries get zero rows
in attn1 and invalid landmarks identity rows in attn2, so the inverse stays
well conditioned. Plain PyTorch with autograd, as the JAX package's is plain
``jnp``: there is no kernel on this path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from acmil_tpu_torch.ops.masked import masked_softmax


def newton_schulz_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of each ``[..., m, m]`` matrix by the
    cubic Newton iteration of Nystromformer (`nystrom_attention.py:12-27`),
    in float32 whatever ``x``'s dtype. The initial scale is the largest
    absolute row sum times the largest absolute column sum of *each*
    matrix, as in the JAX package (the pip package takes them over the whole
    tensor)."""
    x = x.to(torch.float32)
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    z = x.transpose(-1, -2) / (col.amax(dim=-1, keepdim=True)[..., None]
                               * row.amax(dim=-1, keepdim=True)[..., None])
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


def nystrom_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_landmarks: int,
    pinv_iterations: int = 6,
    return_attn_rows: int = 0,
    attn_row_offset: int = 0,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The masked Nystrom core over projected heads.

    ``q``, ``k``, ``v``: ``[B, H, N, Dh]`` (q already scaled), N a multiple
    of ``num_landmarks``; ``mask``: ``[B, N]`` bool or None. With
    ``return_attn_rows`` r > 0 it also rebuilds the full attention rows of
    the r queries from ``attn_row_offset`` on (the cls token after the
    front padding), averaged over heads. The products with the float32
    inverse run in float32, as JAX promotes them.

    Returns ``(out [B, H, N, Dh] float32, attn_rows [B, r, N] | None)``.
    """
    b, h, n, dh = q.shape
    m = num_landmarks
    if n % m:
        raise ValueError(f"sequence {n} not divisible by landmarks {m}")
    l = n // m

    if mask is not None:
        mk = mask[:, None, :, None].to(q.dtype)
        q, k, v = q * mk, k * mk, v * mk

    q_l = q.reshape(b, h, m, l, dh).sum(dim=3)
    k_l = k.reshape(b, h, m, l, dh).sum(dim=3)
    if mask is not None:
        counts = mask.reshape(b, m, l).sum(dim=-1)               # [B, m]
        divisor = counts[:, None, :, None].to(q.dtype) + eps
        lm_valid = counts > 0
    else:
        divisor = torch.tensor(float(l), dtype=q.dtype, device=q.device)
        lm_valid = None
    q_l = q_l / divisor
    k_l = k_l / divisor

    sim1 = torch.einsum("bhnd,bhmd->bhnm", q, k_l)
    sim2 = torch.einsum("bhid,bhjd->bhij", q_l, k_l)
    sim3 = torch.einsum("bhmd,bhnd->bhmn", q_l, k)

    if mask is not None:
        pos = mask[:, None, :]                                    # [B,1,N]
        lm = lm_valid[:, None, :]                                 # [B,1,m]
        attn1 = masked_softmax(sim1, lm[:, :, None, :])
        attn2 = masked_softmax(sim2, lm[:, :, None, :])
        attn3 = masked_softmax(sim3, pos[:, :, None, :])
        attn1 = attn1 * pos[..., None].to(q.dtype)
        attn3 = attn3 * lm[..., None].to(q.dtype)
        eye = torch.eye(m, dtype=q.dtype, device=q.device)
        lm_row = lm[..., None].to(q.dtype)                        # [B,1,m,1]
        attn2 = attn2 * lm_row + eye * (1.0 - lm_row)
    else:
        attn1 = torch.softmax(sim1, dim=-1)
        attn2 = torch.softmax(sim2, dim=-1)
        attn3 = torch.softmax(sim3, dim=-1)

    attn2_inv = newton_schulz_pinv(attn2, pinv_iterations)
    f32 = torch.float32
    out = (attn1.to(f32) @ attn2_inv) @ (attn3 @ v).to(f32)

    attn_rows = None
    if return_attn_rows > 0:
        r, off = return_attn_rows, attn_row_offset
        rows = (attn1[:, :, off:off + r].to(f32) @ attn2_inv) @ attn3.to(f32)
        attn_rows = rows.mean(dim=1)
    return out, attn_rows


def depthwise_seq_conv(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head depthwise conv along the sequence, the value residual
    (`nystrom_attention.py:61-65`, ``Conv2d(heads, heads, (k, 1),
    groups=heads)``), zero-padded at both ends. ``v [B, H, N, Dh]``,
    ``w [H, k]``; the output has ``v``'s shape and dtype."""
    h, ksize = w.shape
    return F.conv2d(v, w[:, None, :, None].to(v.dtype),
                    padding=(ksize // 2, 0), groups=h)
