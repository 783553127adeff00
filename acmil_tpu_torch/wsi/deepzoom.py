"""DeepZoom tile generator over any slide, the port of
``acmil_tpu/wsi/deepzoom.py``.

Reference: `wsi_core/KfbSlide/kfb_deepzoom.py:15` (`KfbDeepZoomGenerator`)
and the tile math in `kfbslide.py:82-120` — a DeepZoom pyramid view
(power-of-two zoom levels down to 1x1) with fixed-size tiles, used by
slide viewers. Works over every slide of :mod:`acmil_tpu_torch.wsi.slide`
(image, SPY, OpenSlide, KFB). ``cv2`` is imported at use.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


class DeepZoomGenerator:
    def __init__(self, slide, tile_size: int = 254, overlap: int = 1):
        self.slide = slide
        self.tile_size = tile_size
        self.overlap = overlap
        w0, h0 = slide.dimensions
        # deepzoom levels: from 1x1 up to full resolution
        self.level_count = int(math.ceil(math.log2(max(w0, h0)))) + 1
        self._dz_dims: List[Tuple[int, int]] = []
        for lvl in range(self.level_count):
            ds = 2 ** (self.level_count - 1 - lvl)
            self._dz_dims.append((max(1, int(math.ceil(w0 / ds))),
                                  max(1, int(math.ceil(h0 / ds)))))

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return list(self._dz_dims)

    @property
    def level_tiles(self) -> List[Tuple[int, int]]:
        return [(int(math.ceil(w / self.tile_size)),
                 int(math.ceil(h / self.tile_size)))
                for (w, h) in self._dz_dims]

    def get_tile(self, dz_level: int, address: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 tile at DeepZoom (level, (col, row))."""
        import cv2

        col, row = address
        dz_w, dz_h = self._dz_dims[dz_level]
        ds = 2 ** (self.level_count - 1 - dz_level)

        # tile extent in deepzoom-level pixels (with overlap)
        x0 = col * self.tile_size - (self.overlap if col > 0 else 0)
        y0 = row * self.tile_size - (self.overlap if row > 0 else 0)
        x1 = min((col + 1) * self.tile_size + self.overlap, dz_w)
        y1 = min((row + 1) * self.tile_size + self.overlap, dz_h)
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0:
            raise IndexError(f"tile {address} out of range at level "
                             f"{dz_level}")

        # read from the best native level and resize
        native = self.slide.best_level_for_downsample(ds)
        nds = self.slide.level_downsamples[native]
        # read_region takes level-0 coords and a native-level size
        nw = max(int(tw * ds / nds), 1)
        nh = max(int(th * ds / nds), 1)
        img = self.slide.read_region((int(x0 * ds), int(y0 * ds)), native,
                                     (nw, nh))
        if (nw, nh) != (tw, th):
            interp = cv2.INTER_AREA if tw < nw else cv2.INTER_LINEAR
            img = cv2.resize(img, (tw, th), interpolation=interp)
        return img
