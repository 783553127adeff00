"""TransMIL, the square-grid correlated MIL transformer: the port of
``acmil_tpu/models/transmil.py`` (reference: `architecture/transMIL.py`,
``TransMIL:48``, ``TransLayer:8``, ``PPEG:31``, over the vendored Nystrom
attention).

As in the JAX package, the bag is padded to a static grid (``_grid_shape``)
and its pad slots are masked, and re-zeroed after every mixing block, so no
conv can leak them into valid rows; ``pad_mode="wrap"`` keeps the
reference's exact semantics instead (the grid filled by repeating the
leading valid patches, which then attend as real rows), for serving
reference checkpoints. Module and parameter names are the reference's, so a
reference ``state_dict`` loads as it is and
``scripts/import_torch_checkpoint.py::convert_transmil`` reads the port's.

Weights are torch's defaults drawn from a ``torch.Generator`` (the
reference stack has no custom init): ``U(±1/sqrt(fan_in))`` for every
Linear and conv, ``cls_token`` from N(0, 1), LayerNorms at ones and zeros.
``dtype=torch.bfloat16`` runs the Linear layers of the Nystrom blocks and
``_fc1`` in bf16 and returns float32, as the flax ``dtype`` does; the
pseudo-inverse stays float32. LayerNorm eps is flax's 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.models.common import (dropout, torch_linear_init_,
                                           xavier_normal_init_)
from acmil_tpu_torch.models.emb_position import torch_conv_init_
from acmil_tpu_torch.ops.nystrom import depthwise_seq_conv, nystrom_attention

LN_EPS = 1e-6


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to ``dtype`` (flax
    ``Dense(dtype=...)``)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


class NystromAttention(nn.Module):
    """qkv projection, the masked Nystrom core, the value-conv residual and
    the output projection (`nystrom_attention.py:30-149`). ``to_qkv``,
    ``to_out.0`` and ``res_conv`` as the reference names them.

    The sequence is front-padded to a multiple of the landmark count; the
    pad rows are masked unless ``strict_pad``, where they attend as real
    rows, as in the pip package, which never gets a mask. ``init`` is
    ``"torch"`` (torch defaults) or ``"xavier"`` (MHIM's SAttention:
    xavier-normal Linear weights, zero biases; the conv keeps torch's
    default)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 num_landmarks: int = 256, pinv_iterations: int = 6,
                 residual: bool = True, residual_conv_kernel: int = 33,
                 droprate: float = 0.0, dtype: torch.dtype = torch.float32,
                 strict_pad: bool = False,
                 generator: Optional[torch.Generator] = None,
                 init: str = "torch"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        self.droprate = droprate
        self.dtype = dtype
        self.strict_pad = strict_pad
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(droprate))
        if init == "xavier":
            xavier_normal_init_(self, generator)
        else:
            torch_linear_init_(self, generator)
        self.res_conv = None
        if residual:
            self.res_conv = torch_conv_init_(nn.Conv2d(
                heads, heads, (residual_conv_kernel, 1),
                padding=(residual_conv_kernel // 2, 0), groups=heads,
                bias=False), generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, return_attn_rows: int = 0,
                generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        m = min(self.num_landmarks, n)
        pad = (-n) % m
        if pad:
            x = F.pad(x, (0, 0, pad, 0))
            if mask is None:
                mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
            mask = F.pad(mask, (pad, 0), value=bool(self.strict_pad))

        qkv = _linear(self.to_qkv, x, self.dtype)

        def heads_first(t):
            return t.reshape(b, t.shape[1], h, dh).transpose(1, 2)

        q, k, v = (heads_first(t) for t in qkv.chunk(3, dim=-1))
        q = q * (dh ** -0.5)
        out, rows = nystrom_attention(
            q, k, v, mask, m, self.pinv_iterations,
            return_attn_rows=return_attn_rows, attn_row_offset=pad)
        if self.res_conv is not None:
            # zero the masked slots first: v at pad rows is nonzero once
            # trained, and the 33-wide conv would mix it into valid rows
            v_in = v if mask is None else v * mask[:, None, :, None].to(v.dtype)
            out = out + depthwise_seq_conv(v_in, self.res_conv.weight[:, 0, :, 0])
        out = out.transpose(1, 2).reshape(b, -1, h * dh)
        out = _linear(self.to_out[0], out, self.dtype).to(torch.float32)
        if not deterministic and self.droprate > 0:
            out = dropout(out, self.droprate, generator)
        out = out[:, -n:]
        if return_attn_rows:
            return out, rows[:, :, -n:]
        return out


class TransLayer(nn.Module):
    """Pre-norm Nystrom block with a residual (`transMIL.py:8-28`): 8 heads
    of ``dim // 8``, ``dim // 2`` landmarks, dropout 0.1 on the attention's
    output. ``norm`` and ``attn`` as the reference names them."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 strict_pad: bool = False,
                 generator: Optional[torch.Generator] = None,
                 init: str = "torch"):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = NystromAttention(
            dim, heads=8, dim_head=dim // 8, num_landmarks=dim // 2,
            pinv_iterations=6, residual=True, droprate=0.1, dtype=dtype,
            strict_pad=strict_pad, generator=generator, init=init)

    def forward(self, x, mask=None, deterministic: bool = True,
                return_attn_rows: int = 0,
                generator: Optional[torch.Generator] = None):
        y = self.norm(x)
        if return_attn_rows:
            y, rows = self.attn(y, mask, deterministic, return_attn_rows,
                                generator)
            return x + y, rows
        return x + self.attn(y, mask, deterministic, generator=generator)


class PPEG(nn.Module):
    """Pyramid position encoding: depthwise 7/5/3 convs with bias over the
    grid view of the body, the cls token passed through (`transMIL.py:31-46`;
    ``proj``, ``proj1``, ``proj2`` as the reference names them)."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = torch_conv_init_(nn.Conv2d(dim, dim, 7, 1, 3, groups=dim),
                                     generator)
        self.proj1 = torch_conv_init_(nn.Conv2d(dim, dim, 5, 1, 2, groups=dim),
                                      generator)
        self.proj2 = torch_conv_init_(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim),
                                      generator)

    def forward(self, x: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
        b, _, c = x.shape
        cls_tok, feat = x[:, :1], x[:, 1:]
        img = feat.transpose(1, 2).reshape(b, c, grid_h, grid_w)
        img = img + self.proj(img) + self.proj1(img) + self.proj2(img)
        feat = img.reshape(b, c, -1).transpose(1, 2)
        return torch.cat([cls_tok, feat], dim=1)


def _grid_shape(n: int, square: bool = False):
    """Static near-square factorisation of the padded bag length: ``2^ceil(
    k/2) x 2^floor(k/2)`` for n = 2^k, else (or with ``square``, the
    reference's grid that wrap mode needs) ``ceil(sqrt(n))`` squared."""
    k = int(math.ceil(math.log2(max(n, 1))))
    if square or 2 ** k != n:
        g = int(math.ceil(math.sqrt(n)))
        return g, g
    return 2 ** ((k + 1) // 2), 2 ** (k // 2)


def wrap_to_grid(h: torch.Tensor, mask: Optional[torch.Tensor],
                 grid_n: int):
    """The reference's wrap padding within a static grid: rows ``j %
    n_valid`` of the valid-prefix bag ``h [B, N, C]`` fill ``grid_n`` slots,
    valid up to the reference's per-bag ``ceil(sqrt(n_valid))²`` window;
    slots past it are masked and zeroed. Returns ``(body [B, grid_n, C],
    mask [B, grid_n])``."""
    b, n, _ = h.shape
    nv = (mask.sum(-1).to(torch.int32) if mask is not None
          else torch.full((b,), n, dtype=torch.int32, device=h.device))
    nv = nv.clamp_min(1)
    ref_g = torch.ceil(torch.sqrt(nv.to(torch.float32))).to(torch.int32)
    ref_n = torch.clamp(ref_g * ref_g, max=grid_n)                # [B]
    j = torch.arange(grid_n, device=h.device)[None, :]
    idx = (j % nv[:, None]).long()
    body = torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))
    win = j < ref_n[:, None]
    return body * win[..., None].to(body.dtype), win


class TransMIL(nn.Module):
    """``_fc1`` (Linear + ReLU), ``cls_token``, ``layer1``, ``pos_layer``
    (PPEG), ``layer2``, ``norm`` and ``_fc2``, as the reference names them.
    ``pad_mode`` is ``"zero"`` (masked zero pad slots, the default) or
    ``"wrap"`` (the reference's exact semantics, see :func:`wrap_to_grid`;
    its Nystrom front pads attend as real rows).

    ``forward(feats [B, N, D_feat], mask [B, N])`` returns the logits
    ``[B, C]``, with ``return_attn`` also the cls token's attention over the
    bag ``[B, N]`` from the second layer's rebuilt rows. Dropout draws come
    from ``generator``."""

    def __init__(self, n_class: int, d_feat: int, d_inner: int = 512,
                 dtype: torch.dtype = torch.float32, pad_mode: str = "zero",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pad_mode not in ("zero", "wrap"):
            raise ValueError(f"pad_mode must be zero|wrap, got {pad_mode!r}")
        self.pad_mode = pad_mode
        self.dtype = dtype
        strict = pad_mode == "wrap"
        self._fc1 = nn.Sequential(nn.Linear(d_feat, d_inner), nn.ReLU())
        torch_linear_init_(self._fc1, generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d_inner))
        with torch.no_grad():
            self.cls_token.normal_(0.0, 1.0, generator=generator)
        self.layer1 = TransLayer(d_inner, dtype, strict, generator)
        self.pos_layer = PPEG(d_inner, generator)
        self.layer2 = TransLayer(d_inner, dtype, strict, generator)
        self.norm = nn.LayerNorm(d_inner, eps=LN_EPS)
        self._fc2 = torch_linear_init_(nn.Linear(d_inner, n_class), generator)

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        b, n, _ = feats.shape
        h = torch.relu(_linear(self._fc1[0], feats, self.dtype)).to(torch.float32)
        gh, gw = _grid_shape(n, square=self.pad_mode == "wrap")
        grid_n = gh * gw
        if self.pad_mode == "wrap":
            h, mask = wrap_to_grid(h, mask, grid_n)
        else:
            if grid_n > n:
                h = F.pad(h, (0, 0, 0, grid_n - n))
                if mask is None:
                    mask = torch.ones((b, n), dtype=torch.bool, device=h.device)
                mask = F.pad(mask, (0, grid_n - n))
            if mask is not None:
                h = h * mask[..., None].to(h.dtype)

        h = torch.cat([self.cls_token.expand(b, -1, -1), h], dim=1)
        full_mask = None
        if mask is not None:
            full_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                              device=h.device), mask], dim=1)

        def rezero(t):
            if full_mask is None:
                return t
            return t * full_mask[..., None].to(t.dtype)

        h = rezero(self.layer1(h, full_mask, deterministic,
                               generator=generator))
        h = rezero(self.pos_layer(h, gh, gw))
        if return_attn:
            h, rows = self.layer2(h, full_mask, deterministic, 1,
                                  generator=generator)
        else:
            h = self.layer2(h, full_mask, deterministic, generator=generator)
        logits = self._fc2(self.norm(h[:, 0]))
        if return_attn:
            return logits, rows[:, 0, 1:1 + n]
        return logits
