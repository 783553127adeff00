"""Tumor annotation parsing, the port of ``acmil_tpu/wsi/annotations.py``.

Reference: `wsi_core/WholeSlideImage.py:51-88` — `initXML` (Camelyon-style
ASAP XML: Annotation → Coordinate X/Y attributes) and `initTxt`
(dict-per-region format with Polygon coordinate groups). Returns contours
as ``[N, 1, 2]`` int32 arrays in level-0 coordinates, sorted by area
descending like the reference. ``cv2`` (the contour areas) is imported at
use.
"""

from __future__ import annotations

import ast
import json
from typing import List
from xml.dom import minidom

import numpy as np


def _by_area(contours: List[np.ndarray]) -> List[np.ndarray]:
    import cv2

    return sorted(contours, key=cv2.contourArea, reverse=True)


def load_xml_annotations(xml_path: str) -> List[np.ndarray]:
    doc = minidom.parse(xml_path)
    contours = []
    for anno in doc.getElementsByTagName("Annotation"):
        coords = anno.getElementsByTagName("Coordinate")
        if not coords:
            continue
        pts = np.array(
            [[[int(float(c.attributes["X"].value)),
               int(float(c.attributes["Y"].value))]] for c in coords],
            dtype=np.int32)
        contours.append(pts)
    return _by_area(contours)


def load_txt_annotations(path: str) -> List[np.ndarray]:
    """`initTxt` format: a literal list of dicts with 'type' and
    'coordinates' keys (`WholeSlideImage.py:61-88`)."""
    with open(path) as f:
        text = f.read()
    try:
        annot = json.loads(text)
    except json.JSONDecodeError:
        annot = ast.literal_eval(text)
    contours = []
    for group in annot:
        coord_groups = group["coordinates"]
        if group.get("type") == "Polygon":
            for contour in coord_groups:
                contours.append(
                    np.asarray(contour, np.int32).reshape(-1, 1, 2))
        else:
            for sub in coord_groups:
                contours.append(
                    np.asarray(sub, np.int32).reshape(-1, 1, 2))
    return _by_area(contours)
