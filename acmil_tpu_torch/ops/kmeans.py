"""k-means and PCA whitening on the device, the port of
``acmil_tpu/ops/kmeans.py``: the faiss replacement that builds IBMIL's
confounder dictionary.

Reference: `IBMIL_clustering.py:25-57` (faiss ``PCAMatrix`` with
``eigen_power=-0.5`` whitening, then L2 normalisation), `run_kmeans:60`
(20 Lloyd iterations) and `reduce:118` (centroids of the *raw* features).

Everything runs in float32 on the device of the input tensor. Eigenvector
signs are arbitrary, so whitened points agree with the JAX package's up to
a sign per axis, which keeps every pairwise distance. The k-means++ draws
come from a CPU ``torch.Generator(seed)``, the same on every device; they
cannot equal JAX's PRNG draws, so :func:`_lloyd` takes its initial
centroids as an argument, as the JAX one does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


EPS = 1e-10
N_ITER = 20


def pca_whiten(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """PCA-reduce to ``dim`` axes, whiten (eigenvalue power -0.5),
    L2-normalise (`preprocess_features`, `IBMIL_clustering.py:25-57`).
    ``dim=-1`` keeps the input dim (no reduction), as the clustering's
    ``Kmeans(pca_dim=-1)`` does."""
    x = torch.as_tensor(x).to(torch.float32)
    if 0 < dim < x.shape[1]:
        xc = x - x.mean(dim=0, keepdim=True)
        evals, evecs = torch.linalg.eigh(xc.t() @ xc / x.shape[0])  # ascending
        top = evecs[:, -dim:].flip(1)
        lam = evals[-dim:].flip(0).clamp_min(EPS)
        x = (xc @ top) * lam ** -0.5
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + EPS)


def _assign(x: torch.Tensor, x2: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d = x2 - 2.0 * (x @ c.t()) + (c * c).sum(dim=1)[None, :]
    return torch.argmin(d, dim=1)


def _lloyd(x: torch.Tensor, init_centroids: torch.Tensor, k: int,
           n_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iter`` Lloyd iterations from ``init_centroids [k, D]``; an empty
    cluster keeps its centroid. Returns (centroids [k, D], assignments
    [N])."""
    x2 = (x * x).sum(dim=1, keepdim=True)                       # [N, 1]
    c = init_centroids.to(x.dtype)
    for _ in range(n_iter):
        onehot = F.one_hot(_assign(x, x2, c), k).to(x.dtype)    # [N, K]
        counts = onehot.sum(dim=0)[:, None]                     # [K, 1]
        c = torch.where(counts > 0, (onehot.t() @ x) / counts.clamp_min(1.0),
                        c)
    return c, _assign(x, x2, c)


def kmeans(x, k: int, seed: int = 66, device: Optional[torch.device] = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster L2-normalised features on ``device`` (``x``'s own when None)
    with ``N_ITER`` Lloyd iterations; returns (assignments [N], centroids of
    the RAW features [k, D]) as `reduce` does
    (`IBMIL_clustering.py:118-136`): clustering runs in the preprocessed
    space, centroids are means of the raw features. k-means++
    initialisation: the first centroid uniform, each next one drawn
    proportional to the squared distance to the nearest centroid so far.
    (The JAX function's ``pca_dim`` and ``n_iter``, which no caller sets,
    are fixed at -1 and 20.)"""
    raw = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    xb = pca_whiten(raw)
    n = xb.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    idx = int(torch.randint(n, (1,), generator=gen))
    centroids = [xb[idx]]
    d_min = ((xb - xb[idx]) ** 2).sum(dim=-1)                   # [N]
    for _ in range(1, k):
        p = d_min.double().cpu()
        p = p / p.sum().clamp_min(1e-12)
        idx = int(torch.multinomial(p, 1, generator=gen))
        centroids.append(xb[idx])
        d_min = torch.minimum(d_min, ((xb - xb[idx]) ** 2).sum(dim=-1))
    _, assign = _lloyd(xb, torch.stack(centroids), k, N_ITER)
    onehot = F.one_hot(assign, k).to(raw.dtype)
    raw_centroids = (onehot.t() @ raw) / onehot.sum(dim=0)[:, None].clamp_min(1.0)
    return assign.cpu().numpy(), raw_centroids.cpu().numpy()


def build_confounder_prototypes(bag_feats, k: int = 8, seed: int = 66,
                                device: Optional[torch.device] = None
                                ) -> np.ndarray:
    """The IBMIL confounder dictionary: k-means centroids over training bag
    features (`IBMIL_clustering.py:118-145`), computed on ``device``."""
    return kmeans(bag_feats, k, seed=seed, device=device)[1]
