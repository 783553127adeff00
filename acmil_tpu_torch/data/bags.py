"""The padded, length-bucketed feature bag, the port of
``acmil_tpu/data/bags.py``.

Bags are padded to power-of-two buckets and carry a validity mask: the
pooling kernel takes masks, and the tests compare padded bags with the JAX
package's. Collation happens on the host in numpy; :meth:`Bag.to` moves a
batch to a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


@dataclass
class Bag:
    """A batch of padded patch-feature bags.

    Attributes:
      feats:  ``[B, N_pad, D]`` patch features (float16/float32).
      mask:   ``[B, N_pad]`` bool — True for real patches.
      coords: ``[B, N_pad, 2]`` int32 slide-space patch coordinates.
      label:  ``[B]`` int64 slide labels.
    """

    feats: torch.Tensor
    mask: torch.Tensor
    coords: torch.Tensor
    label: torch.Tensor

    def pin_memory(self) -> "Bag":
        return Bag(*(t.pin_memory() for t in self._fields()))

    def to(self, device, non_blocking: bool = False) -> "Bag":
        return Bag(*(t.to(device, non_blocking=non_blocking)
                     for t in self._fields()))

    def _fields(self):
        return self.feats, self.mask, self.coords, self.label


def bucket_length(n: int, min_bucket: int = 256, max_patches: int = 65536) -> int:
    """Round ``n`` up to the next power-of-two bucket (clamped)."""
    n = max(1, min(n, max_patches))
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_patches)


def _subsample(feats, coords, max_patches):
    """Keep a uniform subsample rather than truncating a spatial prefix."""
    idx = np.linspace(0, len(feats) - 1, max_patches).astype(np.int64)
    return feats[idx], (np.asarray(coords)[idx] if coords is not None else None)


def pad_bag(
    feats: np.ndarray,
    coords: np.ndarray | None = None,
    label: int = 0,
    n_pad: int | None = None,
    min_bucket: int = 256,
    max_patches: int = 65536,
    dtype=np.float32,
) -> Bag:
    """Pad a single ``[N, D]`` bag to a bucketed ``[1, N_pad, D]`` Bag."""
    feats = np.asarray(feats)
    if len(feats) > max_patches:
        feats, coords = _subsample(feats, coords, max_patches)
    n, d = feats.shape
    if n_pad is None:
        n_pad = bucket_length(n, min_bucket, max_patches)
    out = np.zeros((1, n_pad, d), dtype=dtype)
    out[0, :n] = feats
    mask = np.zeros((1, n_pad), dtype=bool)
    mask[0, :n] = True
    co = np.zeros((1, n_pad, 2), dtype=np.int32)
    if coords is not None:
        co[0, :n] = np.asarray(coords, dtype=np.int32)[:n]
    return Bag(torch.from_numpy(out), torch.from_numpy(mask),
               torch.from_numpy(co), torch.tensor([label], dtype=torch.int64))


def collate_bags(
    feats_list: Sequence[np.ndarray],
    coords_list: Sequence[np.ndarray | None],
    labels: Sequence[int],
    min_bucket: int = 256,
    max_patches: int = 65536,
    dtype=np.float32,
) -> Bag:
    """Collate several variable-length bags into one padded batch.

    All bags in the batch share one bucketed N_pad (the max length's bucket);
    the loader groups similar-length bags to minimise waste.
    """
    lens = [min(len(f), max_patches) for f in feats_list]
    n_pad = bucket_length(max(lens), min_bucket, max_patches)
    b = len(feats_list)
    d = feats_list[0].shape[1]
    feats = np.zeros((b, n_pad, d), dtype=dtype)
    mask = np.zeros((b, n_pad), dtype=bool)
    coords = np.zeros((b, n_pad, 2), dtype=np.int32)
    for i, (f, c) in enumerate(zip(feats_list, coords_list)):
        f = np.asarray(f)
        if len(f) > max_patches:
            f, c = _subsample(f, c, max_patches)
        n = len(f)
        feats[i, :n] = f
        mask[i, :n] = True
        if c is not None:
            coords[i, :n] = np.asarray(c, dtype=np.int32)[:n]
    return Bag(torch.from_numpy(feats), torch.from_numpy(mask),
               torch.from_numpy(coords),
               torch.as_tensor(np.asarray(labels, dtype=np.int64)))


def bucket_plan(lengths: Sequence[int], batch: int, min_bucket: int = 256,
                max_patches: int = 65536) -> List[List[int]]:
    """Group dataset indices into batches of similar bucketed length.

    Returns a list of index groups; each group's bags share one N_pad bucket
    so a batch never pays for one outlier slide.
    """
    order = np.argsort(np.asarray(lengths))
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bucket = None
    for i in order:
        b = bucket_length(int(lengths[i]), min_bucket, max_patches)
        if cur and (len(cur) >= batch or b != cur_bucket):
            groups.append(cur)
            cur = []
        cur.append(int(i))
        cur_bucket = b
    if cur:
        groups.append(cur)
    return groups
