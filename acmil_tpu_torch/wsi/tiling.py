"""Step1 patch coordinates for Step2: the reader of
``acmil_tpu/wsi/tiling.py`` (``load_coords_h5``), and the same schema in a
torch file for machines without ``h5py`` (``save_coords_pt`` /
``load_coords_pt``). Tiling itself waits for the Step1 slice."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _scalar_downsample(attrs: dict) -> dict:
    # reference dumps store 'downsample' as a 2-element (dx, dy) array
    # (WholeSlideImage.py:390); Step2's patch-size arithmetic needs a scalar
    if "downsample" in attrs:
        attrs["downsample"] = float(np.asarray(attrs["downsample"]).ravel()[0])
    return attrs


def load_coords_h5(path: str):
    """(coords [N, 2], labels [N] or None, attrs) from a Step1 coords H5
    (schema at ``WholeSlideImage.py:550-563``)."""
    import h5py

    with h5py.File(path, "r") as f:
        coords = np.asarray(f["coords"][:])
        labels = np.asarray(f["labels"][:]) if "labels" in f else None
        attrs = dict(f["coords"].attrs)
    return coords, labels, _scalar_downsample(attrs)


def save_coords_pt(path: str, coords, attrs: dict,
                   labels: Optional[np.ndarray] = None) -> None:
    """The Step1 coords schema in a torch file: ``coords`` int64 [N, 2],
    optional ``labels`` and the attributes of the H5's ``coords`` dataset
    as plain Python values."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plain = {k: (np.asarray(v).tolist() if isinstance(v, (np.ndarray,
                                                          np.generic)) else v)
             for k, v in attrs.items()}
    obj = {"coords": torch.as_tensor(np.asarray(coords, np.int64)),
           "attrs": plain}
    if labels is not None:
        obj["labels"] = torch.as_tensor(np.asarray(labels))
    torch.save(obj, path)


def load_coords_pt(path: str):
    """:func:`load_coords_h5`'s result from a :func:`save_coords_pt` file."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    labels = obj.get("labels")
    return (obj["coords"].numpy(), None if labels is None else labels.numpy(),
            _scalar_downsample(dict(obj["attrs"])))
