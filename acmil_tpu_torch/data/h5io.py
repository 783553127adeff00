"""HDF5 feature-bag IO, the port of ``acmil_tpu/data/h5io.py``: drop-in
compatible with the reference dump format. ``h5py`` is imported at first use.

Schema (written by the reference's Step2, `Step2_feature_extract.py:164-167`):
one HDF5 group per slide name, datasets ``feat`` (float16 ``[N, D]``) and
``coords`` (``[N, 2]``), plus a ``label`` int attribute. Split construction
mirrors `datasets/datasets.py`:

- camelyon: frozen JSON splits (``splits/camelyon/split_{seed}.json``,
  `datasets.py:16-22`), else name-based 'test' partition + random 10% val.
- bracs: per-slide ``split_info`` column in a CSV manifest with 7→3/2 class
  remapping (`datasets.py:47-83`).
- lct: 6→4/2 class remapping, random 60/20/20 (`datasets.py:85-...`).
- few-shot subsetting of train by per-class cap (`datasets.py:179`).

Unlike the reference (which loads every split fully into RAM,
`datasets.py:38-41`), bags are read lazily per slide by default; pass
``preload=True`` to match the reference behaviour when RAM allows.

The split helpers and :func:`build_hdf5_feat_dataset` also take a torch
feature file (``data/ptio.py``, picked by suffix as
``ptio.open_feature_source`` picks it), which needs no ``h5py``.
"""

from __future__ import annotations

import json
import os
import random
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from acmil_tpu_torch.data.ptio import PT_SUFFIXES, PtBagSource


def _h5py():
    """``h5py``, imported at first use. Concurrent readers (loader prefetch
    threads) must not serialize on POSIX locks (the reference does the same:
    `Step2_feature_extract.py:3`, `Step3_*.py:4`)."""
    os.environ.setdefault("HDF5_USE_FILE_LOCKING", "FALSE")
    import h5py

    return h5py


def write_feature_h5(path: str, slides: Dict[str, dict]) -> None:
    """Write bags in the reference schema. ``slides[name]`` needs keys
    ``feat`` ([N, D]), ``coords`` ([N, 2]) and ``label`` (int)."""
    h5py = _h5py()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for name, d in slides.items():
            g = f.create_group(name)
            g.create_dataset("feat", data=np.asarray(d["feat"], dtype=np.float16))
            g.create_dataset("coords", data=np.asarray(d["coords"], dtype=np.int64))
            g.attrs["label"] = int(d["label"])


def feature_names(path: str) -> List[str]:
    """Slide names in a feature H5 or torch feature file, in file order."""
    if path.endswith(PT_SUFFIXES):
        return PtBagSource(path).names
    with _h5py().File(path, "r") as f:
        return list(f.keys())


class FeatureBagSource:
    """A named subset of slides inside one feature-H5 file."""

    def __init__(
        self,
        file_path: str,
        names: Sequence[str],
        label_map: Optional[Dict[int, int]] = None,
        preload: bool = False,
    ):
        self.file_path = file_path
        self.names = list(names)
        self.label_map = label_map
        self._file = None
        self._cache: Optional[Dict[str, dict]] = None
        self._lengths: Optional[List[int]] = None
        if preload:
            self._cache = {n: self._read(n) for n in self.names}

    def _h5(self):
        if self._file is None:
            self._file = _h5py().File(self.file_path, "r")
        return self._file

    def _read(self, name: str) -> dict:
        g = self._h5()[name]
        label = int(g.attrs["label"])
        if self.label_map is not None:
            label = self.label_map[label]
        return {
            "input": np.asarray(g["feat"][:], dtype=np.float32),
            "coords": np.asarray(g["coords"][:]) if "coords" in g else None,
            "label": label,
            "name": name,
        }

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> dict:
        name = self.names[i]
        if self._cache is not None:
            return self._cache[name]
        return self._read(name)

    def lengths(self) -> List[int]:
        """Bag lengths without loading features (cheap metadata read)."""
        if self._lengths is None:
            f = self._h5()
            self._lengths = [int(f[n]["feat"].shape[0]) for n in self.names]
        return self._lengths

    def label_of(self, name: str) -> int:
        """Slide label without loading features (attrs-only read)."""
        label = int(self._h5()[name].attrs["label"])
        return self.label_map[label] if self.label_map is not None else label

    def feat_dim(self) -> int:
        return int(self._h5()[self.names[0]]["feat"].shape[1])

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# ---------------------------------------------------------------------------
# Split construction (reference: datasets/datasets.py)
# ---------------------------------------------------------------------------

BRACS_3CLASS = {0: 0, 1: 0, 2: 0, 3: 1, 4: 1, 5: 2, 6: 2}
BRACS_2CLASS = {0: 0, 1: 0, 2: 0, 3: 1, 4: 1, 5: 1, 6: 1}
LCT_4CLASS = {0: 0, 1: 1, 2: 2, 3: 3, 4: 3, 5: 3}
LCT_2CLASS = {0: 0, 1: 1, 2: 1, 3: 1, 4: 1, 5: 1}


def _camelyon_names(file_path: str, conf) -> Tuple[List[str], List[str], List[str]]:
    split_file = os.path.join(
        getattr(conf, "split_dir", "./splits"), conf.dataset, f"split_{conf.seed}.json"
    )
    if os.path.exists(split_file):
        with open(split_file) as f:
            d = json.load(f)
        return d["train_names"], d["val_names"], d["test_names"]
    # The reference protocol ALWAYS loads a frozen split JSON
    # (`datasets/datasets.py:16-22`, splits/camelyon/split_{seed}.json with
    # 242/27/129 slides). Falling back to a random split breaks
    # comparability with every published number — never do it silently.
    warnings.warn(
        f"frozen split file {split_file!r} not found — falling back to a "
        f"RANDOM train/val split (seed={conf.seed}). Results are NOT "
        "comparable to the reference protocol; point conf.split_dir at the "
        "shipped splits/ directory (splits/camelyon/split_{1..5}.json).",
        stacklevel=2,
    )
    slide_names = feature_names(file_path)
    test = [n for n in slide_names if "test" in n]
    train_val = [n for n in slide_names if "test" not in n]
    rng = random.Random(conf.seed)
    rng.shuffle(train_val)
    n_val = max(1, int(0.1 * len(train_val)))
    return train_val[n_val:], train_val[:n_val], test


def _bracs_names(file_path: str, conf) -> Tuple[List[str], List[str], List[str]]:
    csv_path = getattr(conf, "bracs_csv", "./dataset_csv/bracs.csv")
    import pandas as pd

    info = pd.read_csv(csv_path).set_index("slide_id")
    slide_names = feature_names(file_path)
    tr, va, te = [], [], []
    for n in slide_names:
        s = info.loc[n]["split_info"]
        (tr if s == "train" else va if s == "val" else te).append(n)
    return tr, va, te


def _lct_names(file_path: str, conf) -> Tuple[List[str], List[str], List[str]]:
    split_file = os.path.join(
        getattr(conf, "split_dir", "./splits"), conf.dataset, f"split_{conf.seed}.json"
    )
    if os.path.exists(split_file):
        with open(split_file) as f:
            d = json.load(f)
        return d["train_names"], d["val_names"], d["test_names"]
    warnings.warn(
        f"frozen split file {split_file!r} not found — falling back to a "
        f"RANDOM 60/20/20 split (seed={conf.seed}); results are NOT "
        "comparable to the reference protocol.", stacklevel=2)
    slide_names = feature_names(file_path)
    rng = random.Random(conf.seed)
    rng.shuffle(slide_names)
    n = len(slide_names)
    n_test, n_val = int(0.2 * n), int(0.2 * n)
    return slide_names[n_test + n_val:], slide_names[n_test:n_test + n_val], slide_names[:n_test]


def _source(file_path: str, names: Sequence[str],
            label_map: Optional[Dict[int, int]], preload: bool):
    """The bag source of a feature file, picked by suffix; a torch file is
    memory-mapped, so ``preload`` does not apply to it."""
    if file_path.endswith(PT_SUFFIXES):
        return PtBagSource(file_path, names, label_map)
    return FeatureBagSource(file_path, names, label_map, preload=preload)


def _fewshot(source, n_shot: int, seed: int):
    """Cap the train split at n_shot slides per class (datasets.py:179)."""
    if n_shot is None or n_shot < 0:
        return source
    by_class: Dict[int, List[str]] = {}
    for name in source.names:
        # attrs-only label read — source[i] would load (and f32-convert)
        # every slide's full feature matrix just to learn its class
        by_class.setdefault(source.label_of(name), []).append(name)
    rng = random.Random(seed)
    keep: List[str] = []
    for lab, names in sorted(by_class.items()):
        rng.shuffle(names)
        keep.extend(names[:n_shot])
    return _source(source.file_path, keep, source.label_map,
                   getattr(source, "_cache", None) is not None)


def build_hdf5_feat_dataset(file_path: str, conf):
    """Return (train, val, test) bag sources — mirrors
    `build_HDF5_feat_dataset` (`datasets/datasets.py:196`). ``file_path``
    is the reference's H5 dump or a torch feature file."""
    ds = conf.dataset
    label_map = None
    if ds == "bracs":
        tr, va, te = _bracs_names(file_path, conf)
        if conf.n_class == 3:
            label_map = BRACS_3CLASS
        elif conf.n_class == 2:
            label_map = BRACS_2CLASS
    elif ds == "lct":
        tr, va, te = _lct_names(file_path, conf)
        if conf.n_class == 4:
            label_map = LCT_4CLASS
        elif conf.n_class == 2:
            label_map = LCT_2CLASS
    else:  # camelyon and anything camelyon-shaped
        tr, va, te = _camelyon_names(file_path, conf)

    have = set(feature_names(file_path))
    missing = [n for n in (*tr, *va, *te) if n not in have]
    if missing:
        raise ValueError(
            f"{len(missing)} split slide names are not in {file_path!r} "
            f"(e.g. {missing[:3]}); the split (dataset={conf.dataset!r}, "
            f"seed={conf.seed}) does not describe this feature dump. If "
            "these are not protocol slides, point split_dir elsewhere or "
            "use a seed without a frozen split file.")

    preload = bool(getattr(conf, "preload", False))
    train = _fewshot(_source(file_path, tr, label_map, preload),
                     getattr(conf, "n_shot", -1), conf.seed)
    val = _source(file_path, va, label_map, preload)
    test = _source(file_path, te, label_map, preload)
    return train, val, test
