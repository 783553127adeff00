"""Slide abstraction and open factory with an LRU handle cache, the port of
``acmil_tpu/wsi/slide.py``.

:class:`ImageSlide` is an in-memory pyramid over one RGB array, with the
openslide vocabulary every reference call site uses (``level_count``,
``level_dimensions``, ``level_downsamples``, ``best_level_for_downsample``,
``read_region``) and the scale-based interface of the reference's
``SlideBase`` (``read``, ``get_slide_window_info``, ``get_thumbnail``),
which every slide inherits. :func:`open_slide` opens PNG/JPEG/BMP files
(``cv2``, imported at use, as ``read`` imports it) as an
:class:`ImageSlide`, and every other container
(SPY, OpenSlide formats, KFB) as a ``wsi/native.py::NativeSlide``; it keeps
the last 16 open (``_LRUSlideCache``, the reference's
`wsi_core/LRUCacheDict.py:3`).
"""

from __future__ import annotations

import os
import sys
import threading
from collections import OrderedDict
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

    def read(self, location: Tuple[int, int], size_l0: Tuple[int, int],
             scale: float) -> np.ndarray:
        """Scale-space read (reference `SlideBase.read`,
        `wsi_core/SlideBase.py:6-64`): a level-0 window read at an
        arbitrary output ``scale`` (output = size_l0 * scale), from the best
        pyramid level, resized with ``cv2``."""
        import cv2

        lvl = self.best_level_for_downsample(1.0 / scale)
        lds = self.level_downsamples[lvl]
        w_l = max(int(size_l0[0] / lds), 1)
        h_l = max(int(size_l0[1] / lds), 1)
        img = self.read_region(location, lvl, (w_l, h_l))
        out_w = max(int(size_l0[0] * scale), 1)
        out_h = max(int(size_l0[1] * scale), 1)
        if (out_w, out_h) != (w_l, h_l):
            interp = cv2.INTER_AREA if out_w < w_l else cv2.INTER_LINEAR
            img = cv2.resize(img, (out_w, out_h), interpolation=interp)
        return img

    def get_slide_window_info(self, window_l0: int, overlap_l0: int = 0):
        """Sliding-window plan over the slide (`SlideBase.
        get_slide_window_info`, `SlideBase.py:66`): the level-0 (x, y)
        origins covering the whole slide, row by row."""
        w0, h0 = self.dimensions
        step = max(window_l0 - overlap_l0, 1)
        xs = list(range(0, max(w0 - overlap_l0, 1), step))
        ys = list(range(0, max(h0 - overlap_l0, 1), step))
        return [(x, y) for y in ys for x in xs]

    def get_thumbnail(self, max_size: int = 1024) -> np.ndarray:
        """The whole slide at the level that best fits ``max_size`` (the
        level's own size, not resized)."""
        ds = max(self.dimensions) / max_size
        lvl = self.best_level_for_downsample(ds)
        w, h = self.level_dimensions[lvl]
        return self.read_region((0, 0), lvl, (w, h))

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
# the JAX package's slide extensions: pyramid containers and images
SLIDE_EXTS = (".spy", ".svs", ".tif", ".tiff", ".ndpi", ".mrxs", ".kfb",
              ".png", ".jpg", ".jpeg")


class _LRUSlideCache:
    """Thread-safe LRU of open slide handles (reference
    `wsi_core/LRUCacheDict.py:3` + lock at `wsi_core/__init__.py:7-8`)."""

    def __init__(self, max_open: int = 16):
        self.max_open = max_open
        self._cache: "OrderedDict[str, Slide]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, path: str):
        with self._lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
            return None

    def put(self, path: str, slide: Slide):
        with self._lock:
            self._cache[path] = slide
            self._cache.move_to_end(path)
            while len(self._cache) > self.max_open:
                _, evicted = self._cache.popitem(last=False)
                # close eagerly only when the cache held the only reference
                # (the local binding + getrefcount's argument); a slide a
                # caller still holds stays usable
                if sys.getrefcount(evicted) <= 2:
                    evicted.close()

    def clear(self):
        with self._lock:
            for s in self._cache.values():
                s.close()
            self._cache.clear()


_CACHE = _LRUSlideCache()


def clear_slide_cache() -> None:
    _CACHE.clear()


def open_slide(path: str, cache: bool = True) -> Slide:
    """An :class:`ImageSlide` for an image file, else a ``NativeSlide``
    (SPY, KFB or OpenSlide by the suffix), from the handle cache when
    ``cache`` and it was opened before."""
    path = os.path.abspath(path)
    if cache:
        hit = _CACHE.get(path)
        if hit is not None:
            return hit
    ext = os.path.splitext(path)[1].lower()
    slide: Slide
    if ext in IMAGE_EXTS:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        slide = ImageSlide(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    else:
        from acmil_tpu_torch.wsi.native import NativeSlide

        slide = NativeSlide(path)
    if cache:
        _CACHE.put(path, slide)
    return slide
