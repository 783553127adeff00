"""Stitching and patch quality filters, the port of
``acmil_tpu/wsi/stitch.py``.

Reference: `wsi_core/wsi_utils.py` — `StitchCoords:247` /
`DrawMapFromCoords:188` (downsampled mosaic of extracted patches for
visual QA), `isWhitePatch:10` / `isBlackPatch:17` filters, and
`to_percentiles:29`. ``cv2`` and ``scipy`` are imported where they are
used.
"""

from __future__ import annotations

import numpy as np


def is_white_patch(patch: np.ndarray, sat_thresh: float = 5.0) -> bool:
    """Mostly-background patch: low mean saturation (`wsi_utils.py:10`)."""
    import cv2

    sat = cv2.cvtColor(patch, cv2.COLOR_RGB2HSV)[:, :, 1]
    return bool(sat.mean() < sat_thresh)


def is_black_patch(patch: np.ndarray, rgb_thresh: float = 40.0) -> bool:
    return bool(patch.mean() < rgb_thresh)


def to_percentiles(scores: np.ndarray) -> np.ndarray:
    """Rank-transform scores to [0, 100] (`wsi_utils.py:29`)."""
    from scipy.stats import rankdata

    return rankdata(scores, "average") / len(scores) * 100


class MosaicCanvas:
    """Packs fixed-size patches into a grid mosaic (`Mosaic_Canvas`,
    `wsi_core/util_classes.py:6`) — used to assemble sampled-ROI sheets."""

    def __init__(self, patch_size: int = 256, n: int = 100, downscale: int = 4,
                 n_per_row: int = 10, alpha: float = -1):
        self.patch = patch_size // downscale
        self.n_per_row = n_per_row
        n_rows = -(-n // n_per_row)
        self.canvas = np.full((n_rows * self.patch, n_per_row * self.patch, 3),
                              255, np.uint8)
        self._i = 0
        self.capacity = n

    def paste(self, patch: np.ndarray) -> None:
        if self._i >= self.capacity:
            raise IndexError("mosaic canvas full")
        if patch.shape[0] != self.patch:
            import cv2

            patch = cv2.resize(patch[..., :3], (self.patch, self.patch))
        r, c = divmod(self._i, self.n_per_row)
        self.canvas[r * self.patch:(r + 1) * self.patch,
                    c * self.patch:(c + 1) * self.patch] = patch[..., :3]
        self._i += 1

    def save(self, path: str) -> None:
        import cv2

        cv2.imwrite(path, cv2.cvtColor(self.canvas, cv2.COLOR_RGB2BGR))


def sample_rois(scores: np.ndarray, coords: np.ndarray, k: int = 5,
                mode: str = "range_sample", seed: int = 1,
                score_start: float = 0.45, score_end: float = 0.55,
                top_left=None, bot_right=None) -> dict:
    """Sample ROI coords by attention score (`sample_rois`,
    `wsi_utils.py:137-160`): percentile-normalise, optionally crop to a
    window, then range-sample / topk / reverse-topk."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    coords = np.asarray(coords)
    scores = to_percentiles(scores) / 100.0
    if top_left is not None and bot_right is not None:
        keep = ((coords[:, 0] >= top_left[0]) & (coords[:, 0] <= bot_right[0])
                & (coords[:, 1] >= top_left[1]) & (coords[:, 1] <= bot_right[1]))
        scores, coords = scores[keep], coords[keep]
    if mode == "range_sample":
        in_range = np.flatnonzero((scores >= score_start) & (scores <= score_end))
        rng = np.random.default_rng(seed)
        sel = rng.choice(in_range, size=min(k, len(in_range)), replace=False)
    elif mode == "topk":
        sel = np.argsort(-scores)[:k]
    elif mode == "reverse_topk":
        sel = np.argsort(scores)[:k]
    else:
        raise NotImplementedError(mode)
    return {"sampled_coords": coords[sel], "sampled_scores": scores[sel]}


def stitch_coords(slide, coords: np.ndarray, patch_size_l0: int,
                  canvas_max: int = 2048,
                  draw_grid: bool = True) -> np.ndarray:
    """Downsampled mosaic of the tiled patches (`StitchCoords`,
    `wsi_utils.py:247`)."""
    import cv2

    w0, h0 = slide.dimensions
    scale = min(canvas_max / w0, canvas_max / h0, 1.0)
    cw, ch = max(int(w0 * scale), 1), max(int(h0 * scale), 1)
    canvas = np.full((ch, cw, 3), 240, np.uint8)
    ps = max(int(patch_size_l0 * scale), 1)
    read_level = slide.best_level_for_downsample(1.0 / scale)
    lds = slide.level_downsamples[read_level]
    for (x, y) in np.asarray(coords):
        size_l = max(int(patch_size_l0 / lds), 1)
        patch = slide.read_region((int(x), int(y)), read_level,
                                  (size_l, size_l))
        patch = cv2.resize(patch, (ps, ps), interpolation=cv2.INTER_AREA)
        cx, cy = int(x * scale), int(y * scale)
        x2, y2 = min(cx + ps, cw), min(cy + ps, ch)
        canvas[cy:y2, cx:x2] = patch[: y2 - cy, : x2 - cx]
        if draw_grid:
            cv2.rectangle(canvas, (cx, cy), (x2, y2), (0, 0, 0), 1)
    return canvas
