"""Slide abstraction and open factory, the port of the image part of
``acmil_tpu/wsi/slide.py``.

:class:`ImageSlide` is an in-memory pyramid over one RGB array, with the
openslide vocabulary every reference call site uses (``level_count``,
``level_dimensions``, ``level_downsamples``, ``best_level_for_downsample``,
``read_region``). :func:`open_slide` opens PNG/JPEG/BMP files (``cv2``,
imported only there). Pyramid containers (SPY, OpenSlide, KFB) need the
native reader, which waits for the Step1 slice (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Slide:
    """Abstract multi-resolution slide."""

    level_count: int
    level_dimensions: Sequence[Tuple[int, int]]   # (w, h) per level
    level_downsamples: Sequence[float]
    properties: Dict[str, str]

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    def best_level_for_downsample(self, downsample: float) -> int:
        """Largest level whose downsample <= requested (openslide
        semantics)."""
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 0.01:
                best = i
        return best

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 [h, w, 3]; ``location`` in level-0 coordinates."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class ImageSlide(Slide):
    """Pyramid over one in-memory RGB array (levels by 2x area-mean
    downsampling until max dim < 1024)."""

    def __init__(self, image: np.ndarray, properties: Optional[dict] = None):
        img = np.ascontiguousarray(np.asarray(image, np.uint8)[..., :3])
        self._levels: List[np.ndarray] = [img]
        while max(self._levels[-1].shape[:2]) >= 1024:
            cur = self._levels[-1]
            h2, w2 = cur.shape[0] // 2 * 2, cur.shape[1] // 2 * 2
            ds = cur[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3)
            self._levels.append(ds.mean(axis=(1, 3)).astype(np.uint8))
        self.level_count = len(self._levels)
        self.level_dimensions = [(l.shape[1], l.shape[0]) for l in self._levels]
        self.level_downsamples = [
            self.level_dimensions[0][0] / l.shape[1] for l in self._levels]
        self.properties = dict(properties or {})

    def read_region(self, location, level, size) -> np.ndarray:
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        w, h = int(size[0]), int(size[1])
        lvl = self._levels[level]
        out = np.full((h, w, 3), 255, np.uint8)  # white past the edge
        x1, y1 = max(x0, 0), max(y0, 0)
        x2 = min(x0 + w, lvl.shape[1])
        y2 = min(y0 + h, lvl.shape[0])
        if x2 > x1 and y2 > y1:
            out[y1 - y0:y2 - y0, x1 - x0:x2 - x0] = lvl[y1:y2, x1:x2]
        return out


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
# the JAX package's slide extensions
SLIDE_EXTS = (".spy", ".svs", ".tif", ".tiff", ".ndpi", ".mrxs", ".kfb",
              ".png", ".jpg", ".jpeg")


def open_slide(path: str) -> Slide:
    """An :class:`ImageSlide` for an image file; other containers raise
    NotImplementedError."""
    ext = os.path.splitext(path)[1].lower()
    if ext in IMAGE_EXTS:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        return ImageSlide(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    raise NotImplementedError(
        f"{ext} slides need the native pyramid reader, which acmil_tpu_torch "
        "has not ported yet (ROADMAP.md, Queue A: the Step1 slice)")
