"""BMIL, Bayesian MIL with variational-dropout layers, the port of
``acmil_tpu/models/bmil.py`` (reference: `architecture/bmil.py`,
``probabilistic_MIL_Bayes_{vis,enc,spvis}:179,243,332``, and
`architecture/linear_vdo.py:10`).

- ``BMILVis`` (``bmil_vis``; ``bmil_enc`` with ``with_kl``): a gated
  attention net gives each patch (μ, log σ²); the attention is the sigmoid
  of a reparameterised Gaussian sample (of μ in eval); the bag feature is
  the attention-weighted mean; the classifier is a ``LinearVDO``. ``enc``
  adds a KL against the class-dependent logistic-normal prior.
- ``BMILSpvis`` (``bmil_spvis``): each patch's (μ, log σ²) goes onto a
  static ``grid x grid`` canvas at its scaled coords, μ is Gaussian
  smoothed (3x3, σ 0.5), the KL against the prior is the grid's mean.

The JAX package's choices are kept: LinearVDO returns its mean in eval;
the variance's ε is added inside the product and once more outside it, so
an all-zero padded row has a finite sqrt gradient; the coords' int cast
truncates toward 0. The ARD KL of the model (``kl_model``) is summed over
the module's ``LinearVDO`` and ``Conv2dVDO`` children by ``BMILFamily``;
``Conv2dVDO`` is the JAX module's variational conv, which no head builds.

**The spvis scatter.** Many patches share a cell of the 64x64 canvas. XLA's
``.at[ix].set`` promises no order for duplicate indices and neither do
torch's ``index_put_``/``scatter_`` on CUDA, so the port fixes one: in each
cell the valid patch with the highest index wins, by a ``scatter_reduce``
(amax) of patch indices and a gather of the winners' values. The gradient
reaches the winners only. The JAX package on the CPU gives the same rule
(the last duplicate wins, and only it gets a gradient), and the tests hold
the port to it on a bag built to collide.

The stochastic draws (dropout, each LinearVDO's noise, the
reparameterisation) come from the ``generator`` passed to the forward, in
the JAX module's order, or from tensors passed in ``noise`` (keyed
``"attn"`` for the reparameterisation and by the LinearVDO's attribute
name) — the port's convention C2. Parameter names: ``attention_net.0``,
``attention_net.{2|3}`` (the gated net, at 3 after a dropout) and
``classifiers`` (``weight``, ``bias``, ``log_alp``) for vis/enc, the
reference's, read by
``scripts/import_torch_checkpoint.py::convert_bmil_vis``; spvis, which has
no converter, names its layers ``fc``, ``attention_a``, ``attention_b``,
``attention_c`` and ``classifiers``. Linear weights are xavier-normal with
zero biases; LinearVDO weights N(0, 0.01²) with log α at ``ard_init``; all
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import (Attn_Net_Gated, dropout,
                                           xavier_normal_init_)
from acmil_tpu_torch.parallel.mesh import batch_mean, batch_total, draw

_EPS = 1e-8
PRIOR_MU = (-5.0, 0.0)        # class-dependent prior (bmil.py:352-353)
PRIOR_LOGVAR = (-1.0, 3.0)


def vdo_kl(log_alp: torch.Tensor) -> torch.Tensor:
    """The ARD KL approximation (`linear_vdo.py:87-103`) of a ``[in, out]``
    log α, as the JAX function takes it: ``-sum(mean over out)``."""
    k1, k2, k3 = 0.6134, 0.2026, 0.7126
    elt = (-0.5 * torch.log1p(torch.exp(-log_alp))
           + k1 * torch.exp(-(k2 + k3 * log_alp) ** 2))
    return -elt.mean(dim=-1).sum()


def _normal(shape, like: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    return draw(shape, generator, like.device, like.dtype, normal=True)


class LinearVDO(nn.Module):
    """Variational-dropout linear layer (`linear_vdo.py:10-67`): training
    samples activations from N(xW, x²(α ⊙ W²)); eval returns the mean.
    ``weight`` and ``log_alp`` are ``[out, in]``, torch's layout."""

    def __init__(self, in_features: int, out_features: int,
                 ard_init: float = -8.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.log_alp = nn.Parameter(torch.full((out_features, in_features),
                                               float(ard_init)))
        self.bias = nn.Parameter(torch.zeros(out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.01, generator=generator)

    def kl(self) -> torch.Tensor:
        return vdo_kl(self.log_alp.t())

    def forward(self, x, stochastic: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        mu = F.linear(x, self.weight, self.bias)
        if not stochastic:
            return mu
        var = F.linear(x * x, torch.exp(self.log_alp) * self.weight ** 2
                       + _EPS) + _EPS
        eps = noise if noise is not None else _normal(mu.shape, mu, generator)
        return mu + eps * torch.sqrt(var)


class Conv2dVDO(nn.Module):
    """Variational-dropout conv layer (`linear_vdo.py:124-249`), the conv
    analogue of :class:`LinearVDO`: the mean conv, and in training a sampled
    variance term, the conv of x² with α ⊙ W². Bias-free (the reference
    notes that a bias gives NaN); same padding, stride 1. Takes and returns
    ``[B, H, W, C]`` as the JAX module does; ``weight`` and ``log_alp`` are
    ``[out, in, k, k]``, torch's layout. As there, the variance's ε is added
    inside the conv and once more outside it: an all-zero input window (a
    padded grid region) then has a finite sqrt gradient."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 ard_init: float = -1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (features, in_channels, kernel, kernel)
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(shape))
        self.log_alp = nn.Parameter(torch.full(shape, float(ard_init)))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.01, generator=generator)

    def kl(self) -> torch.Tensor:
        """``vdo_kl`` of log α as the JAX module sows it: ``[k, k, in,
        out]`` flattened to ``[k k in, out]``."""
        return vdo_kl(self.log_alp.permute(2, 3, 1, 0)
                      .reshape(-1, self.log_alp.shape[0]))

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise`` ([B, H, W, out]) stands for the draw of ε when given."""
        pad = self.kernel // 2
        xc = x.permute(0, 3, 1, 2)
        mu = F.conv2d(xc, self.weight, padding=pad)
        if deterministic:
            return mu.permute(0, 2, 3, 1)
        var = F.conv2d(xc * xc, torch.exp(self.log_alp) * self.weight ** 2
                       + _EPS, padding=pad) + _EPS
        mu, var = mu.permute(0, 2, 3, 1), var.permute(0, 2, 3, 1)
        eps = noise if noise is not None else _normal(mu.shape, mu, generator)
        return mu + eps * torch.sqrt(var)


def gaussian_kernel2d(ksize: int = 3, sigma: float = 0.5) -> np.ndarray:
    ax = np.arange(ksize, dtype=np.float32) - (ksize - 1) / 2
    g = np.exp(-(ax / sigma) ** 2 / 2) / (sigma * math.sqrt(2 * math.pi))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _kl_logistic_normal(mu_pr, mu_pos, logvar_pr, logvar_pos):
    """`bmil.py:364-365` (the reference's own formula squares logvar)."""
    return (logvar_pr - logvar_pos) / 2.0 + (
        logvar_pos ** 2 + (mu_pr - mu_pos) ** 2) / (2.0 * logvar_pr ** 2) - 0.5


def _prior(label: torch.Tensor, like: torch.Tensor):
    """The prior's (μ, log σ²) per bag. The prior has two classes; a label
    past 1 takes class 1's, as the JAX package's clamped gather gives it."""
    # filled on the device: a host tuple made a tensor there is a copy
    mu, lv = (torch.stack([torch.full((), v, dtype=like.dtype,
                                      device=like.device) for v in vals])
              for vals in (PRIOR_MU, PRIOR_LOGVAR))
    idx = label.long().clamp(0, len(PRIOR_MU) - 1)
    return mu[idx], lv[idx]


def _weighted_mean(A: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bn,bnd->bd", A, h) / A.sum(dim=1, keepdim=True
                                                   ).clamp_min(_EPS)


def _draw(noise, key, shape, like, generator):
    if noise is not None and key in noise:
        return noise[key]
    return _normal(shape, like, generator)


class BMILVis(nn.Module):
    """vis/enc variants (`bmil.py:179,243`): per-patch Gaussian attention.
    ``with_kl`` turns on the enc-style class-prior KL."""

    def __init__(self, n_class: int, d_feat: int, d_hidden: int = 512,
                 d_attn: int = 256, droprate: float = 0.25,
                 with_kl: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.droprate, self.with_kl = droprate, with_kl
        fc = [nn.Linear(d_feat, d_hidden), nn.ReLU()]
        if droprate:
            fc.append(nn.Dropout(droprate))
        fc.append(Attn_Net_Gated(d_hidden, d_attn, 0.0, 2))
        self.attention_net = nn.Sequential(*fc)
        self.classifiers = LinearVDO(d_hidden, n_class, ard_init=-3.0,
                                     generator=generator)
        xavier_normal_init_(self, generator)

    def forward(self, feats, mask=None, coords=None, label=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """``{"logits" [B, C], "attn" [B, 1, N], "kl_data", "kl_model"}``;
        ``kl_model`` is 0 here (``BMILFamily`` fills it). A training forward
        (``deterministic=False`` on a module in train mode) samples."""
        stochastic = self.training and not deterministic
        h = torch.relu(self.attention_net[0](_as_weight_dtype(feats, self)))
        if stochastic and self.droprate:
            h = dropout(h, self.droprate, generator)
        ag = self.attention_net[-1]
        params2 = ag.attention_c(torch.tanh(ag.attention_a[0](h))
                                 * torch.sigmoid(ag.attention_b[0](h)))
        mu, logvar = params2[..., 0], params2[..., 1]             # [B, N]
        g = mu
        if stochastic:
            g = mu + _draw(noise, "attn", mu.shape, mu, generator) \
                * torch.exp(0.5 * logvar)
        A = torch.sigmoid(g)
        if mask is not None:
            A = A * mask.to(A.dtype)
        logits = self.classifiers(
            _weighted_mean(A, h), stochastic, generator,
            None if noise is None else noise.get("classifiers"))

        kl_data = torch.zeros((), dtype=logits.dtype, device=logits.device)
        if self.with_kl and label is not None:
            mu_pr, lv_pr = _prior(label, mu)
            kl = _kl_logistic_normal(mu_pr[:, None], mu, lv_pr[:, None], logvar)
            if mask is not None:
                kl_data = (kl * mask.to(kl.dtype)).sum() / batch_total(
                    mask.sum()).clamp_min(1)
            else:
                kl_data = batch_mean(kl)
        return {"logits": logits, "attn": A[:, None, :], "kl_data": kl_data,
                "kl_model": torch.zeros_like(kl_data)}


def grid_cells(coords: Optional[torch.Tensor], mask: Optional[torch.Tensor],
               b: int, n: int, grid: int, device) -> torch.Tensor:
    """Each patch's canvas cell ``y·G + x`` ``[B, N]`` (int64): coords
    scaled by ``(G - 1) / max(valid coords)`` and truncated toward 0; a
    masked patch gets ``G²`` (no cell)."""
    if coords is None:
        cell = torch.zeros((b, n), dtype=torch.int64, device=device)
    else:
        c = coords.to(torch.float32)
        cz = c if mask is None else torch.where(mask[..., None], c,
                                                torch.zeros_like(c))
        cmax = cz.amax(dim=1, keepdim=True)
        scaled = (c * (grid - 1) / cmax.clamp_min(1.0)).to(torch.int32)
        cell = (scaled[..., 1] * grid + scaled[..., 0]).to(torch.int64)
    if mask is not None:
        cell = torch.where(mask, cell, torch.full_like(cell, grid * grid))
    return cell


def scatter_winners(cell: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The patch index that fills each cell ``[B, n_cells]``: the highest
    index among the patches in it, -1 where none is. ``cell`` values outside
    ``[0, n_cells)`` fill nothing."""
    b, n = cell.shape
    idx = torch.arange(n, device=cell.device).expand(b, n)
    slot = torch.where((cell >= 0) & (cell < n_cells), cell,
                       torch.full_like(cell, n_cells))
    win = torch.full((b, n_cells + 1), -1, dtype=torch.int64,
                     device=cell.device)
    return win.scatter_reduce(1, slot, idx, "amax")[:, :n_cells]


class _CellGather(torch.autograd.Function):
    """``torch.gather(a, 1, cell)`` whose backward sums the gradients of the
    patches of one cell by ``index_put_`` with ``accumulate``: on a card a
    sort, then each cell's sum in the patches' order, where the gather's own
    backward adds them by atomics in the order the threads happen to run.
    A bag has thousands of patches a cell at 64 x 64 past 4096 patches, so
    only this gives a step the same bits on every run, a graph replay's
    and an eager step's alike."""

    @staticmethod
    def forward(ctx, a, cell):
        ctx.save_for_backward(cell)
        ctx.shape = a.shape
        return torch.gather(a, 1, cell)

    @staticmethod
    def backward(ctx, grad):
        (cell,) = ctx.saved_tensors
        rows = torch.arange(cell.shape[0], device=cell.device)[:, None]
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        return out.index_put_((rows.expand_as(cell), cell), grad,
                              accumulate=True), None


class BMILSpvis(nn.Module):
    """spvis variant (`bmil.py:332-443`): a spatial Gaussian attention
    field on a static ``grid x grid`` canvas."""

    def __init__(self, n_class: int, d_feat: int, d_hidden: int = 512,
                 d_attn: int = 256, grid: int = 64, droprate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid, self.droprate = grid, droprate
        ard = -4.0
        self.fc = nn.Linear(d_feat, d_hidden)
        self.attention_a = LinearVDO(d_hidden, d_attn, ard, generator=generator)
        self.attention_b = LinearVDO(d_hidden, d_attn, ard, generator=generator)
        self.attention_c = LinearVDO(d_attn, 2, ard, generator=generator)
        self.classifiers = LinearVDO(d_hidden, n_class, ard_init=-3.0,
                                     generator=generator)
        self.register_buffer("smooth", torch.from_numpy(
            gaussian_kernel2d(3, 0.5))[None, None], persistent=False)
        xavier_normal_init_(self, generator)

    def forward(self, feats, mask=None, coords=None, label=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """As ``BMILVis.forward``; ``coords [B, N, 2]`` (x, y) place the
        patches on the canvas (all in cell 0 when None)."""
        stochastic = self.training and not deterministic
        G = self.grid
        b, n, _ = feats.shape

        def drop(t):
            return (dropout(t, self.droprate, generator)
                    if stochastic and self.droprate else t)

        def vdo(layer, name, t):
            return layer(t, stochastic, generator,
                         None if noise is None else noise.get(name))

        h = torch.relu(drop(self.fc(_as_weight_dtype(feats, self))))
        fa = drop(torch.sigmoid(vdo(self.attention_a, "attention_a", h)))
        fb = drop(torch.tanh(vdo(self.attention_b, "attention_b", h)))
        params2 = vdo(self.attention_c, "attention_c", fa * fb)   # [B, N, 2]

        cell = grid_cells(coords, mask, b, n, G, feats.device)
        win = scatter_winners(cell, G * G)                        # [B, G*G]
        filled = win >= 0
        at = win.clamp_min(0)

        def canvas(vals):
            got = torch.gather(vals, 1, at)
            return torch.where(filled, got, torch.zeros_like(got)).reshape(b, G, G)

        mu, logvar = canvas(params2[..., 0]), canvas(params2[..., 1])

        kl_data = torch.zeros((), dtype=mu.dtype, device=mu.device)
        if label is not None:
            mu_pr, lv_pr = _prior(label, mu)
            kl_data = batch_mean(_kl_logistic_normal(
                mu_pr[:, None, None], mu, lv_pr[:, None, None], logvar))

        mu_s = F.conv2d(mu[:, None], self.smooth.to(mu.dtype), padding=1)[:, 0]
        g = mu_s
        if stochastic:
            g = mu_s + _draw(noise, "attn", mu_s.shape, mu_s, generator) \
                * torch.exp(0.5 * logvar)
        A_grid = torch.sigmoid(g).reshape(b, G * G)
        patch_A = _CellGather.apply(A_grid, cell.clamp(0, G * G - 1))  # [B, N]
        if mask is not None:
            patch_A = patch_A * mask.to(patch_A.dtype)
        logits = vdo(self.classifiers, "classifiers",
                     _weighted_mean(patch_A, h))
        return {"logits": logits, "attn": patch_A[:, None, :],
                "kl_data": kl_data, "kl_model": torch.zeros_like(kl_data)}


def vdo_layers(model: nn.Module):
    return [m for m in model.modules()
            if isinstance(m, (LinearVDO, Conv2dVDO))]


def kl_model(model: nn.Module) -> torch.Tensor:
    """The model's ARD KL: every LinearVDO's and Conv2dVDO's ``vdo_kl``
    summed, what the JAX
    family sums from the sown ``kl`` collection (`get_ard_reg_vdo`,
    `bmil.py:446`)."""
    return sum(m.kl() for m in vdo_layers(model))
