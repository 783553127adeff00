"""Synthetic slides, the port of ``acmil_tpu/wsi/synthetic.py``:
tissue-like blobs on a white background, optionally with a 'tumor' core,
kept in memory. The same seed gives the same pixels as the JAX package."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from acmil_tpu_torch.wsi.slide import ImageSlide


def make_synthetic_slide_image(width: int = 4096, height: int = 3072,
                               n_blobs: int = 4, seed: int = 0,
                               tumor: bool = False) -> Tuple[np.ndarray, list]:
    """Returns (RGB uint8 image, list of tumor-center level-0 coords)."""
    rs = np.random.RandomState(seed)
    img = np.full((height, width, 3), 245, np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    tumor_centers = []
    for i in range(n_blobs):
        cx = rs.randint(width // 5, 4 * width // 5)
        cy = rs.randint(height // 5, 4 * height // 5)
        rx = rs.randint(width // 10, width // 4)
        ry = rs.randint(height // 10, height // 4)
        blob = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) < 1.0
        # eosin-ish pink tissue with texture
        tex = rs.randint(-15, 15, size=(height, width, 3))
        color = np.array([200, 120, 160]) + rs.randint(-20, 20, 3)
        img[blob] = np.clip(color + tex[blob], 0, 255).astype(np.uint8)
        if tumor and i == 0:
            # darker, denser 'tumor' core
            core = (((xx - cx) / (rx * 0.4)) ** 2 +
                    ((yy - cy) / (ry * 0.4)) ** 2) < 1.0
            img[core] = np.clip(np.array([120, 40, 90]) + tex[core], 0,
                                255).astype(np.uint8)
            tumor_centers.append((cx, cy))
    return img, tumor_centers


def make_synthetic_slide(width: int = 4096, height: int = 3072, **kw) -> ImageSlide:
    img, _ = make_synthetic_slide_image(width, height, **kw)
    return ImageSlide(img)
