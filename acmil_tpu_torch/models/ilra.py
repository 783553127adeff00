"""ILRA, low-rank attention MIL (ICLR'23), the port of
``acmil_tpu/models/ilra.py`` (reference: `architecture/ilra.py`,
``MultiHeadAttention:25``, ``GAB:67``, ``NLP:94``, ``ILRA:112``).

GAB blocks route the bag through a small learned latent (``num_inds``
tokens): bag → latent, then latent → bag, O(N·r) instead of O(N²). NLP pools
with learned seed queries. Each attention block keeps both of the
reference's projection stages: its own ``fc_q``/``fc_k``/``fc_v``, then
``nn.MultiheadAttention``'s fused in-projection; the residual adds the
``fc_q`` output, not the in-projected query. Attention is an explicit
masked softmax (bag-side keys respect the mask; latent tokens are always
valid). LayerNorm takes flax's ε = 1e-6, as the JAX package does; the JAX
module's ``ln=False``, which no registry build sets, is not ported.

Parameter names are the reference's (``gab_blocks.{i}.latent``,
``.project_forward``/``.project_backward`` with ``fc_q``, ``fc_k``,
``fc_v``, ``multihead_attn.in_proj_weight``/``in_proj_bias``/``out_proj``,
``fc_o``, ``ln0``, ``ln1``, ``gate.0``; ``pooling.S``, ``pooling.mha``;
``classifier``), which ``scripts/import_torch_checkpoint.py::convert_ilra``
reads. Linear weights are xavier-normal with zero biases (each third of the
in-projection drawn as its own square matrix, as the JAX module's three
Dense layers are); the latent and seed tensors are xavier-uniform with
torch's n-D fans; all from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import xavier_normal_init_
from acmil_tpu_torch.ops.masked import masked_softmax


def _xavier_uniform_nd_(t: torch.Tensor,
                        generator: Optional[torch.Generator]) -> None:
    """torch's ``xavier_uniform_`` fans for an n-D tensor: fan_in =
    shape[1]·prod(shape[2:]), fan_out = shape[0]·prod(shape[2:])."""
    rf = math.prod(t.shape[2:])
    bound = math.sqrt(6.0 / (t.shape[1] * rf + t.shape[0] * rf))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class _InProjection(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its own names:
    ``in_proj_weight [3d, d]`` (q, k, v stacked), ``in_proj_bias [3d]`` and
    ``out_proj``."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def init_(self, generator: Optional[torch.Generator]) -> None:
        d = self.in_proj_weight.shape[1]
        with torch.no_grad():
            self.in_proj_weight.normal_(0.0, math.sqrt(1.0 / d),
                                        generator=generator)
            self.in_proj_bias.zero_()


class _MHA(nn.Module):
    """Pre-projection MHA with residual, LN, relu-FFN residual and an
    optional SiLU gate on the query input (`ilra.py:25-64`)."""

    def __init__(self, dim_q: int, dim_k: int, dim_v: int, num_heads: int,
                 gated: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.fc_q = nn.Linear(dim_q, dim_v)
        self.fc_k = nn.Linear(dim_k, dim_v)
        self.fc_v = nn.Linear(dim_k, dim_v)
        self.multihead_attn = _InProjection(dim_v)
        self.fc_o = nn.Linear(dim_v, dim_v)
        self.ln0 = nn.LayerNorm(dim_v, eps=1e-6)
        self.ln1 = nn.LayerNorm(dim_v, eps=1e-6)
        self.gate = (nn.Sequential(nn.Linear(dim_q, dim_v), nn.SiLU())
                     if gated else None)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        b, n, d = t.shape
        return t.reshape(b, n, self.num_heads, d // self.num_heads
                         ).transpose(1, 2)                        # [B, H, n, dh]

    def forward(self, q_in, k_in, key_mask=None) -> torch.Tensor:
        q0, k0, v0 = self.fc_q(q_in), self.fc_k(k_in), self.fc_v(k_in)
        w, b = self.multihead_attn.in_proj_weight, self.multihead_attn.in_proj_bias
        q, k, v = (F.linear(t, wi, bi) for t, wi, bi in
                   zip((q0, k0, v0), w.chunk(3), b.chunk(3)))
        qh = self._split(q)
        logits = (qh @ self._split(k).transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        m = None if key_mask is None else key_mask[:, None, None, :]
        a = (masked_softmax(logits, m) @ self._split(v)).transpose(1, 2)
        o = self.ln0(q0 + self.multihead_attn.out_proj(a.flatten(2)))
        o = self.ln1(o + torch.relu(self.fc_o(o)))
        if self.gate is not None:
            o = o * self.gate(q_in)
        return o


class GAB(nn.Module):
    """Low-rank global attention block (`ilra.py:67-92`): bag → latent
    (``project_forward``), latent → bag (``project_backward``)."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int,
                 num_inds: int):
        super().__init__()
        self.latent = nn.Parameter(torch.empty(1, num_inds, dim_out))
        self.project_forward = _MHA(dim_out, dim_in, dim_out, num_heads,
                                    gated=True)
        self.project_backward = _MHA(dim_in, dim_out, dim_out, num_heads,
                                     gated=True)

    def forward(self, x, mask=None) -> torch.Tensor:
        latent = self.latent.expand(x.shape[0], -1, -1)
        h = self.project_forward(latent, x, mask)
        return self.project_backward(x, h, None)


class NLP(nn.Module):
    """Non-local pooling with learned seeds (`ilra.py:94-107`)."""

    def __init__(self, dim: int, num_heads: int, num_seeds: int):
        super().__init__()
        self.S = nn.Parameter(torch.empty(1, num_seeds, dim))
        self.mha = _MHA(dim, dim, dim, num_heads)

    def forward(self, x, mask=None) -> torch.Tensor:
        return self.mha(self.S.expand(x.shape[0], -1, -1), x, mask)


class ILRA(nn.Module):
    def __init__(self, n_class: int, d_feat: int = 384, num_layers: int = 2,
                 hidden_feat: int = 256, num_heads: int = 8, topk: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # after the first block the bag lives in hidden_feat dims; the mask
        # still marks which rows are real
        self.gab_blocks = nn.ModuleList(
            GAB(d_feat if i == 0 else hidden_feat, hidden_feat, num_heads,
                topk) for i in range(num_layers))
        self.pooling = NLP(hidden_feat, num_heads, topk)
        self.classifier = nn.Linear(hidden_feat, n_class)
        xavier_normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, _InProjection):
                m.init_(generator)
        for t in [g.latent for g in self.gab_blocks] + [self.pooling.S]:
            _xavier_uniform_nd_(t, generator)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = _as_weight_dtype(feats, self)
        for gab in self.gab_blocks:
            x = gab(x, mask)
        pooled = self.pooling(x, mask)                            # [B, topk, H]
        return self.classifier(pooled[:, 0])
