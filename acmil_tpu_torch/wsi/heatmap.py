"""Attention heatmap rendering (Step4), the port of
``acmil_tpu/wsi/heatmap.py``.

Reference: `wsi_core/WholeSlideImage.py:575-810` (`visHeatmap`): accumulate
per-patch scores into an overlay with an overlap counter, average,
percentile-normalise, colormap per patch and alpha-blend onto the slide,
then `block_blending:770`.

Everything here is host work over a few thousand patches: the scatter-add
of scores and counts is ``torch.Tensor.index_add_`` on CPU tensors, and the
colormap and blending are numpy and ``cv2`` (imported where used). The
``jet`` colormap is computed in numpy, bit-equal to matplotlib's, so the
port needs no matplotlib for Step4's colormap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from acmil_tpu_torch.wsi.stitch import to_percentiles

# matplotlib's published segment data of ``jet`` (``matplotlib._cm._jet_data``):
# per channel, rows (x, y below x, y above x) of a piecewise-linear map
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
_LUT_N = 256        # entries of a matplotlib colormap's lookup table


def _segment_lut(segments, n: int = _LUT_N) -> np.ndarray:
    """One channel's ``n``-entry table, computed as matplotlib's
    ``colors._create_lookup_table`` does (gamma 1)."""
    adata = np.array(segments)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_lut() -> np.ndarray:
    """``jet``'s lookup table, float64 ``[256, 3]`` RGB in [0, 1]."""
    return np.stack([_segment_lut(_JET_SEGMENTS[c])
                     for c in ("red", "green", "blue")], axis=1)


def accumulate_scores(scores: np.ndarray, coords: np.ndarray,
                      patch_size_l0: int, canvas_wh: Tuple[int, int],
                      scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter-add patch scores into a [h, w] canvas, averaging overlaps
    (`WholeSlideImage.py:664-690`); returns (canvas f32, cover uint8)."""
    import cv2

    cw, ch = canvas_wh
    # ceil-scaling matches the reference exactly (`WholeSlideImage.py:643-644`:
    # np.ceil on both the patch size and the coords)
    ps = max(int(np.ceil(patch_size_l0 * scale)), 1)
    xs = np.ceil(np.asarray(coords[:, 0]) * scale).astype(np.int32)
    ys = np.ceil(np.asarray(coords[:, 1]) * scale).astype(np.int32)

    # Each patch covers a ps x ps block: scatter its score to one cell of a
    # ps-downsampled grid, then upsample. The grid exactly tiles the canvas
    # (gw*ps >= cw), so the nearest upsample stays block-aligned.
    gw, gh = -(-cw // ps), -(-ch // ps)
    bx = np.clip(xs // ps, 0, gw - 1)
    by = np.clip(ys // ps, 0, gh - 1)
    flat = torch.from_numpy(by.astype(np.int64) * gw + bx)
    sc = torch.as_tensor(np.asarray(scores), dtype=torch.float32)
    acc = torch.zeros(gh * gw).index_add_(0, flat, sc)
    cnt = torch.zeros(gh * gw).index_add_(0, flat, torch.ones_like(sc))
    grid = (acc / cnt.clamp_min(1.0)).numpy().reshape(gh, gw)
    cnt = cnt.numpy().reshape(gh, gw)
    canvas = cv2.resize(grid, (gw * ps, gh * ps),
                        interpolation=cv2.INTER_NEAREST)[:ch, :cw]
    cover = cv2.resize((cnt > 0).astype(np.uint8), (gw * ps, gh * ps),
                       interpolation=cv2.INTER_NEAREST)[:ch, :cw]
    return canvas, cover


def apply_colormap(canvas: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """Map [h, w] scores in [0, 1] to RGB uint8 the reference's way:
    matplotlib's ``cmap(x) * 255 → uint8`` (`WholeSlideImage.py:728`).

    ``jet`` is computed here, bit-equal to matplotlib's: the value scaled
    by 256 in its own dtype and truncated, 1.0 taking the last entry, NaN
    black, as ``Colormap.__call__`` indexes its table. Any other name needs
    matplotlib, imported here."""
    x = np.clip(canvas, 0.0, 1.0)
    if cmap != "jet":
        from matplotlib import colormaps

        return (colormaps[cmap](x) * 255)[:, :, :3].astype(np.uint8)
    xa = np.array(x, copy=True)
    xa *= _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    lut = np.concatenate([jet_lut(), np.zeros((1, 3))])   # last row: NaN
    idx[bad] = _LUT_N
    return (lut.take(idx, axis=0, mode="clip") * 255).astype(np.uint8)


def block_blend(slide, colored: np.ndarray, cover: np.ndarray,
                read_level: int, alpha: float, block_size: int = 1024,
                blank_canvas: bool = False,
                canvas_color: Tuple[int, int, int] = (255, 255, 255)
                ) -> np.ndarray:
    """Blend the colored overlay against the slide in live-read blocks
    (`WholeSlideImage.py:770-810`): covered pixels get
    ``alpha*overlay + (1-alpha)*slide``, everything else the raw slide —
    without ever holding a second full-level copy of the slide in RAM."""
    import cv2

    h, w = colored.shape[:2]
    ds = slide.level_downsamples[read_level]
    out = np.empty_like(colored)
    for ys in range(0, h, block_size):
        ye = min(h, ys + block_size)
        for xs in range(0, w, block_size):
            xe = min(w, xs + block_size)
            if blank_canvas:
                canvas = np.full((ye - ys, xe - xs, 3), canvas_color,
                                 np.uint8)
            else:
                canvas = slide.read_region(
                    (int(xs * ds), int(ys * ds)), read_level,
                    (xe - xs, ye - ys))
                canvas = np.asarray(canvas)[..., :3]
            blk = colored[ys:ye, xs:xe]
            cov = cover[ys:ye, xs:xe] > 0
            blended = cv2.addWeighted(blk, alpha, canvas, 1 - alpha, 0)
            out[ys:ye, xs:xe] = np.where(cov[..., None], blended, canvas)
    return out


def render_level(slide, vis_level: Optional[int] = None,
                 canvas_max: Optional[int] = 2048) -> int:
    """The level :func:`vis_heatmap` renders at: ``vis_level``, else the
    level closest to 32x downsample (`WholeSlideImage.py:611-612`), or a
    coarser one when ``canvas_max`` bounds the canvas."""
    if vis_level is not None:
        return vis_level
    w0, h0 = slide.dimensions
    target = 32.0
    if canvas_max:
        target = max(target, w0 / canvas_max, h0 / canvas_max)
    return slide.best_level_for_downsample(target)


def vis_heatmap(
    slide,
    scores: np.ndarray,
    coords: np.ndarray,
    patch_size: Tuple[int, int] = (512, 512),
    vis_level: Optional[int] = None,
    alpha: float = 0.4,
    blur: bool = True,
    convert_to_percentiles: bool = True,
    cmap: str = "jet",
    canvas_max: Optional[int] = 2048,
    blank_canvas: bool = False,
    block_size: int = 1024,
) -> np.ndarray:
    """Render the attention overlay; returns an RGB uint8 image of the
    render level's dimensions (`visHeatmap`, `WholeSlideImage.py:575`).

    ``vis_level`` picks the render resolution (default: see
    :func:`render_level`); blending against the slide happens
    block-by-block with live ``read_region`` (`block_blending:770`), so
    large levels never need a full second copy in RAM.
    """
    import cv2

    scores = np.asarray(scores, np.float64).reshape(-1)
    if convert_to_percentiles:
        scores = to_percentiles(scores) / 100.0  # rank-normalise to [0, 1]

    read_level = render_level(slide, vis_level, canvas_max)
    scale = 1.0 / slide.level_downsamples[read_level]
    lw, lh = slide.level_dimensions[read_level]

    canvas, cover = accumulate_scores(scores, coords, patch_size[0],
                                      (lw, lh), scale)
    if blur:
        k = max(int(patch_size[0] * scale) // 2 * 2 + 1, 3)
        canvas = cv2.GaussianBlur(canvas, (k, k), 0)

    colored = apply_colormap(canvas, cmap)

    return block_blend(slide, colored, cover, read_level, alpha,
                       block_size=block_size, blank_canvas=blank_canvas)
