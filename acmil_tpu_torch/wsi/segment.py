"""Tissue segmentation (host-side OpenCV preprocessing), the port of
``acmil_tpu/wsi/segment.py``.

Reference: `wsi_core/WholeSlideImage.py:99-220` (`segmentTissue`): read a
downsampled level, HSV saturation → median blur → binary/Otsu threshold →
optional morphological close → contours with hierarchy → area filtering
(foreground threshold ``a_t``, per-hole threshold ``a_h``, ``max_n_holes``
largest holes kept). Thresholds are expressed at a 512-pixel reference
patch scale like the reference's ``filter_params`` scaling.

This is preprocessing, not a hot path: it stays on the host. ``cv2`` is
imported where it is used.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class SegmentationResult:
    contours: List[np.ndarray]           # tissue contours (seg-level coords)
    holes: List[List[np.ndarray]]        # per-contour holes
    seg_level: int
    downsample: float
    mask: Optional[np.ndarray] = None    # binary mask at seg level


def segment_tissue(
    slide,
    seg_level: Optional[int] = None,
    sthresh: int = 8,
    sthresh_up: int = 255,
    mthresh: int = 7,
    close: int = 4,
    use_otsu: bool = False,
    a_t: float = 100.0,
    a_h: float = 16.0,
    max_n_holes: int = 8,
    ref_patch_size: int = 512,
) -> SegmentationResult:
    """Segment tissue on a slide (defaults = Step1 defaults,
    `Step1_create_patches_fp.py:260-263`)."""
    import cv2

    if seg_level is None:
        seg_level = slide.best_level_for_downsample(64)
    w, h = slide.level_dimensions[seg_level]
    img = slide.read_region((0, 0), seg_level, (w, h))
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    med = cv2.medianBlur(hsv[:, :, 1], mthresh)

    if use_otsu:
        _, binary = cv2.threshold(med, 0, sthresh_up,
                                  cv2.THRESH_OTSU + cv2.THRESH_BINARY)
    else:
        _, binary = cv2.threshold(med, sthresh, sthresh_up, cv2.THRESH_BINARY)
    if close > 0:
        kernel = np.ones((close, close), np.uint8)
        binary = cv2.morphologyEx(binary, cv2.MORPH_CLOSE, kernel)

    ds = slide.level_downsamples[seg_level]
    scale = (ref_patch_size / ds) ** 2  # area scaling like WholeSlideImage.py:208
    a_t_px = a_t * scale
    a_h_px = a_h * scale

    contours, hierarchy = cv2.findContours(binary, cv2.RETR_CCOMP,
                                           cv2.CHAIN_APPROX_NONE)
    if hierarchy is None:
        return SegmentationResult([], [], seg_level, ds, binary)
    hierarchy = np.squeeze(hierarchy, axis=(0,))[:, 2:]

    fg_idx = np.flatnonzero(hierarchy[:, 1] == -1)
    keep: List[int] = []
    keep_holes: List[List[np.ndarray]] = []
    for ci in fg_idx:
        cont = contours[ci]
        hole_ids = np.flatnonzero(hierarchy[:, 1] == ci)
        area = cv2.contourArea(cont) - sum(
            cv2.contourArea(contours[hi]) for hi in hole_ids)
        if area <= a_t_px:
            continue
        keep.append(ci)
        holes = sorted((contours[hi] for hi in hole_ids),
                       key=cv2.contourArea, reverse=True)[:max_n_holes]
        keep_holes.append([hl for hl in holes if cv2.contourArea(hl) > a_h_px])

    return SegmentationResult([contours[i] for i in keep], keep_holes,
                              seg_level, ds, binary)


def save_segmentation(seg: SegmentationResult, path: str) -> None:
    """Persist contours+holes for resume (`saveSegmentation`,
    `WholeSlideImage.py:94-97` pkl format)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump({"tissue": seg.contours, "holes": seg.holes,
                     "seg_level": seg.seg_level,
                     "downsample": seg.downsample}, f)


def load_segmentation(path: str) -> SegmentationResult:
    """`initSegmentation` (`WholeSlideImage.py:88-92`)."""
    import pickle

    with open(path, "rb") as f:
        d = pickle.load(f)
    return SegmentationResult(d["tissue"], d["holes"],
                              d.get("seg_level", 0), d.get("downsample", 1.0))


def scale_contours(contours: List[np.ndarray], scale: float) -> List[np.ndarray]:
    """Scale contours to level-0 coordinates (`WholeSlideImage.py:scaleContourDim`)."""
    return [np.asarray(c * scale, np.int32) for c in contours]


def vis_wsi(slide, seg: SegmentationResult, vis_level: Optional[int] = None,
            line_thickness: int = 12) -> np.ndarray:
    """Draw segmentation contours on a thumbnail (`visWSI`,
    `WholeSlideImage.py:222`)."""
    import cv2

    if vis_level is None:
        vis_level = slide.best_level_for_downsample(64)
    w, h = slide.level_dimensions[vis_level]
    img = slide.read_region((0, 0), vis_level, (w, h)).copy()
    s = seg.downsample / slide.level_downsamples[vis_level]
    conts = [np.asarray(c * s, np.int32) for c in seg.contours]
    cv2.drawContours(img, conts, -1, (0, 255, 0),
                     max(1, int(line_thickness * s)))
    for holes in seg.holes:
        hs = [np.asarray(c * s, np.int32) for c in holes]
        cv2.drawContours(img, hs, -1, (0, 0, 255),
                         max(1, int(line_thickness * s)))
    return img
