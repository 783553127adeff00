"""Feature bags in a torch file: the H5 dump's schema without ``h5py``.

One entry per slide name, holding ``feat`` (float16 ``[N, D]``), ``coords``
(int64 ``[N, 2]``) and ``label`` (int), as in ``data/h5io.py``. Files are
written with ``torch.save`` and opened with ``torch.load(mmap=True,
weights_only=True)``, so opening one reads no features.
:func:`open_feature_source` picks the reader by file suffix.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

PT_SUFFIXES = (".pt", ".pth")


def write_feature_pt(path: str, slides: Dict[str, dict]) -> None:
    """Write bags in the H5 dump's schema to a torch file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        name: {"feat": torch.as_tensor(np.asarray(d["feat"], np.float16)),
               "coords": torch.as_tensor(np.asarray(d["coords"], np.int64)),
               "label": int(d["label"])}
        for name, d in slides.items()}, path)


class PtBagSource:
    """A named subset of slides inside one torch feature file; the same
    interface as :class:`acmil_tpu_torch.data.h5io.FeatureBagSource`."""

    def __init__(self, file_path: str, names: Optional[Sequence[str]] = None,
                 label_map: Optional[Dict[int, int]] = None):
        self.file_path = file_path
        self._slides = torch.load(file_path, map_location="cpu", mmap=True,
                                  weights_only=True)
        self.names = list(self._slides if names is None else names)
        self.label_map = label_map

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> dict:
        name = self.names[i]
        d = self._slides[name]
        return {"input": d["feat"].numpy().astype(np.float32),
                "coords": d["coords"].numpy(),
                "label": self.label_of(name),
                "name": name}

    def lengths(self) -> List[int]:
        return [int(self._slides[n]["feat"].shape[0]) for n in self.names]

    def label_of(self, name: str) -> int:
        label = int(self._slides[name]["label"])
        return self.label_map[label] if self.label_map is not None else label

    def feat_dim(self) -> int:
        return int(self._slides[self.names[0]]["feat"].shape[1])

    def close(self) -> None:
        self._slides = {}


def open_feature_source(path: str, names: Optional[Sequence[str]] = None):
    """Every slide (or ``names``) of a feature file: a torch file for the
    suffixes in ``PT_SUFFIXES``, else the reference's H5."""
    if path.endswith(PT_SUFFIXES):
        return PtBagSource(path, names)
    from acmil_tpu_torch.data.h5io import FeatureBagSource, feature_names

    return FeatureBagSource(path, feature_names(path) if names is None
                            else names)
