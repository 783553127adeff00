"""Grid tiling of segmented contours into Step1 patch coordinates, the
port of ``acmil_tpu/wsi/tiling.py``, and the same coords schema in a torch
file for machines without ``h5py`` (``save_coords_pt`` / ``load_coords_pt``).

Reference: `wsi_core/WholeSlideImage.py:438-563` (`process_contours` /
`process_contour`): meshgrid candidates over each contour's bbox, a
4-point containment predicate per candidate (`util_classes.py:69-115`,
V1/V2/V3 easy/hard), hole exclusion, coords written to the Step1 H5 schema.
Each contour (and its holes) is rasterized once into a bbox-local mask, so
every containment test is a vectorised mask gather, as in the JAX package.
``cv2`` and ``h5py`` are imported where they are used.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from acmil_tpu_torch.wsi.segment import SegmentationResult


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


def _raster(polys: List[np.ndarray], origin_xy: Tuple[int, int],
            shape_wh: Tuple[int, int], scale: float) -> np.ndarray:
    """Rasterize polygons into a bbox-local mask at ``scale``, with a
    1-px zero border so clipped out-of-bbox lookups read 'outside'.
    (bbox-local: a full-slide mask per contour is O(slide area) each.)"""
    import cv2

    ox, oy = origin_xy
    w, h = shape_wh
    mask = np.zeros((h + 2, w + 2), np.uint8)
    for p in polys:
        local = (np.asarray(p, np.float64) - [ox, oy]) * scale + 1.0
        cv2.drawContours(mask, [local.astype(np.int32)], -1, 1, -1)
    return mask


def _four_point_test(mask: np.ndarray, cx: np.ndarray, cy: np.ndarray,
                     shift: int, mode: str) -> np.ndarray:
    """Vectorised 4-point predicates (`isInContourV3_{Easy,Hard}`,
    `util_classes.py:69-115`). cx/cy are patch centers in mask coords."""
    h, w = mask.shape

    def lookup(x, y):
        x = np.clip(x, 0, w - 1)
        y = np.clip(y, 0, h - 1)
        return mask[y, x] > 0

    if mode == "center" or shift <= 0:      # V1/V2-style center check
        return lookup(cx, cy)
    pts = [lookup(cx - shift, cy - shift), lookup(cx + shift, cy + shift),
           lookup(cx + shift, cy - shift), lookup(cx - shift, cy + shift)]
    stacked = np.stack(pts)
    if mode == "four_pt_hard":
        return stacked.all(axis=0)
    return stacked.any(axis=0)              # four_pt (easy)


@dataclass
class TilingResult:
    coords: np.ndarray          # [N, 2] level-0 patch top-left coords
    labels: np.ndarray          # [N] annotation labels (0 when none)
    patch_size: int
    patch_level: int
    attrs: dict


def tile_contours(
    slide,
    seg: SegmentationResult,
    patch_size: int = 512,
    step_size: int = 512,
    patch_level: int = 0,
    contour_fn: str = "four_pt",
    annotations: Optional[List[np.ndarray]] = None,
    mask_scale: float = 1.0 / 16.0,
) -> TilingResult:
    """Grid-tile every segmented contour; returns level-0 coords.

    ``annotations``: optional tumor contours (level-0 coords) — patches
    inside any get label 1 (the Step1 'labels' dataset).
    """
    import cv2

    lvl_ds = slide.level_downsamples[patch_level]
    ref_patch = int(patch_size * lvl_ds)      # patch footprint at level 0
    step = int(step_size * lvl_ds)
    w0, h0 = slide.dimensions

    # contours from seg level -> level 0
    scale0 = seg.downsample
    mw, mh = max(int(w0 * mask_scale), 1), max(int(h0 * mask_scale), 1)

    ann_mask = None
    if annotations:
        ann_mask = np.zeros((mh, mw), np.uint8)
        for a in annotations:
            cv2.drawContours(ann_mask,
                             [np.asarray(a * mask_scale, np.int32)], -1, 1, -1)

    all_coords: List[np.ndarray] = []
    all_labels: List[np.ndarray] = []
    for cont, holes in zip(seg.contours, seg.holes):
        c0 = np.asarray(cont * scale0, np.int32)
        holes0 = [np.asarray(hl * scale0, np.int32) for hl in holes]
        x, y, cw, ch = cv2.boundingRect(c0)
        # full bbox, like the reference's use_padding=True default
        # (`WholeSlideImage.py:471-473`): edge patches are kept (the
        # reader pads past the slide boundary), and small contours still
        # yield their candidates
        gx = np.arange(x, x + cw, step, dtype=np.int64)
        gy = np.arange(y, y + ch, step, dtype=np.int64)
        if len(gx) == 0 or len(gy) == 0:
            continue
        xs, ys = np.meshgrid(gx, gy, indexing="ij")
        cand = np.stack([xs.ravel(), ys.ravel()], axis=1)

        bw = max(int(np.ceil(cw * mask_scale)), 1)
        bh = max(int(np.ceil(ch * mask_scale)), 1)
        cont_mask = _raster([c0], (x, y), (bw, bh), mask_scale)
        cx = ((cand[:, 0] + ref_patch // 2 - x) * mask_scale + 1).astype(np.int64)
        cy = ((cand[:, 1] + ref_patch // 2 - y) * mask_scale + 1).astype(np.int64)
        shift = int(ref_patch // 2 * 0.5 * mask_scale)
        mode = {"four_pt": "four_pt", "four_pt_hard": "four_pt_hard",
                "center": "center", "basic": "center"}[contour_fn]
        # the 4-point predicate tests the CONTOUR only; holes exclude on
        # the patch center, independently — matching isInContours
        # (`WholeSlideImage.py:406-412`: cont_check_fn(pt) and-not
        # isInHoles(center))
        ok = _four_point_test(cont_mask, cx, cy, shift, mode)
        if holes0:
            hole_mask = _raster(holes0, (x, y), (bw, bh), mask_scale)
            in_hole = hole_mask[np.clip(cy, 0, bh + 1),
                                np.clip(cx, 0, bw + 1)] > 0
            ok &= ~in_hole
        coords = cand[ok]
        all_coords.append(coords)
        if ann_mask is not None:
            acx = ((coords[:, 0] + ref_patch // 2) * mask_scale).astype(np.int64)
            acy = ((coords[:, 1] + ref_patch // 2) * mask_scale).astype(np.int64)
            labels = ann_mask[np.clip(acy, 0, mh - 1),
                              np.clip(acx, 0, mw - 1)].astype(np.int64)
        else:
            labels = np.zeros(len(coords), np.int64)
        all_labels.append(labels)

    coords = (np.concatenate(all_coords) if all_coords
              else np.zeros((0, 2), np.int64))
    labels = (np.concatenate(all_labels) if all_labels
              else np.zeros((0,), np.int64))
    attrs = {
        "patch_size": patch_size,
        "patch_level": patch_level,
        "downsample": lvl_ds,
        "downsampled_level_dim": tuple(slide.level_dimensions[patch_level]),
        "level_dim": tuple(slide.level_dimensions[patch_level]),
    }
    return TilingResult(coords, labels, patch_size, patch_level, attrs)


def save_coords_h5(path: str, result: TilingResult, name: str = "") -> None:
    """Step1 coords H5 (schema at `WholeSlideImage.py:550-563`)."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("coords", data=result.coords.astype(np.int64))
        f.create_dataset("labels", data=result.labels)
        for k, v in result.attrs.items():
            d.attrs[k] = v
        d.attrs["name"] = name
