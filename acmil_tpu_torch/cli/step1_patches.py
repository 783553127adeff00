"""Step1 — tissue segmentation and grid tiling into patch coordinates, the
port of ``Step1_create_patches_fp.py``::

    python -m acmil_tpu_torch.cli.step1_patches --source slides/ --save_dir step1/ \\
        --patch_size 512 --step_size 512

It walks a slide directory, segments tissue (``wsi/segment.py``), grid-tiles
the contours (``wsi/tiling.py``) and writes, per slide, its coords to
``patches/<slide>.h5`` (the reference's schema), a contour overlay to
``masks/<slide>.jpg`` and a mosaic of the tiled patches to
``stitches/<slide>.jpg``, with the per-slide resume CSV
``process_list_autogen.csv`` (columns ``slide_id,status,process``; status
``tbp``, ``processed``, ``already_exist``, ``failed_open`` or
``failed_seg``), as the JAX script does.

Two changes for machines without ``pandas`` or ``h5py``: the CSV goes
through the standard ``csv`` module (a slide missing from an existing CSV
joins it with process 1), and ``--coords_format pt`` writes the same coords
schema to ``patches/<slide>.pt`` through ``wsi/tiling.py::save_coords_pt``,
which Step2's ``--coords_format pt`` reads. The work is host work: no
device is involved.
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Dict, List, Optional

from acmil_tpu_torch.wsi.slide import SLIDE_EXTS

CSV_NAME = "process_list_autogen.csv"
CSV_FIELDS = ("slide_id", "status", "process")


def walk_dir(source: str) -> List[str]:
    out = []
    for root, _, files in os.walk(source):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in SLIDE_EXTS:
                out.append(os.path.join(root, f))
    return out


def _read_csv(path: str) -> Dict[str, dict]:
    with open(path, newline="") as f:
        return {row["slide_id"]: row for row in csv.DictReader(f)}


def _write_csv(path: str, rows: Dict[str, dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS, lineterminator="\n")
        w.writeheader()
        w.writerows(rows.values())


def _set_status(rows: Dict[str, dict], sid: str, status: str) -> None:
    rows.setdefault(sid, {"slide_id": sid, "process": "1"})["status"] = status


def seg_and_patch(args) -> Dict[str, dict]:
    """Processes every slide under ``args.source``; returns, per processed
    slide id, its patch count and the seconds of segmentation, tiling and
    stitching."""
    import cv2

    from acmil_tpu_torch.wsi.segment import segment_tissue, vis_wsi
    from acmil_tpu_torch.wsi.slide import open_slide
    from acmil_tpu_torch.wsi.stitch import stitch_coords
    from acmil_tpu_torch.wsi.tiling import (save_coords_h5, save_coords_pt,
                                            tile_contours)

    patch_dir = os.path.join(args.save_dir, "patches")
    mask_dir = os.path.join(args.save_dir, "masks")
    stitch_dir = os.path.join(args.save_dir, "stitches")
    for d in (patch_dir, mask_dir, stitch_dir):
        os.makedirs(d, exist_ok=True)

    slides = walk_dir(args.source)
    csv_path = os.path.join(args.save_dir, CSV_NAME)
    if os.path.exists(csv_path):
        rows = _read_csv(csv_path)
    else:
        rows = {os.path.basename(s): {"slide_id": os.path.basename(s),
                                      "status": "tbp", "process": "1"}
                for s in slides}

    done: Dict[str, dict] = {}
    total_seg, total_patch = 0.0, 0.0
    for path in slides:
        sid = os.path.basename(path)
        name = os.path.splitext(sid)[0]
        coords_path = os.path.join(patch_dir, f"{name}.{args.coords_format}")
        if args.auto_skip and os.path.exists(coords_path):
            print(f"{sid}: exists, skipping")
            _set_status(rows, sid, "already_exist")
            continue
        try:
            slide = open_slide(path)
        except Exception as e:      # any reader failure marks the slide
            print(f"{sid}: failed to open ({e})")
            _set_status(rows, sid, "failed_open")
            _write_csv(csv_path, rows)
            continue
        t0 = time.perf_counter()
        try:
            seg = segment_tissue(slide, sthresh=args.sthresh,
                                 mthresh=args.mthresh, close=args.close,
                                 use_otsu=args.use_otsu, a_t=args.a_t,
                                 a_h=args.a_h, ref_patch_size=args.patch_size)
        except Exception as e:      # as the reference: mark and go on
            print(f"{sid}: failed segmentation ({e})")
            _set_status(rows, sid, "failed_seg")
            _write_csv(csv_path, rows)
            continue
        seg_t = time.perf_counter() - t0
        cv2.imwrite(os.path.join(mask_dir, name + ".jpg"),
                    cv2.cvtColor(vis_wsi(slide, seg), cv2.COLOR_RGB2BGR))

        t0 = time.perf_counter()
        res = tile_contours(slide, seg, patch_size=args.patch_size,
                            step_size=args.step_size,
                            contour_fn=args.contour_fn)
        patch_t = time.perf_counter() - t0
        if args.coords_format == "h5":
            save_coords_h5(coords_path, res, name=name)
        else:
            save_coords_pt(coords_path, res.coords,
                           dict(res.attrs, name=name), res.labels)

        stitch_t = 0.0
        if not args.no_stitch and len(res.coords):
            t0 = time.perf_counter()
            canvas = stitch_coords(slide, res.coords,
                                   int(args.patch_size *
                                       slide.level_downsamples[0]))
            cv2.imwrite(os.path.join(stitch_dir, name + ".jpg"),
                        cv2.cvtColor(canvas, cv2.COLOR_RGB2BGR))
            stitch_t = time.perf_counter() - t0
        print(f"{sid}: {len(res.coords)} patches (seg {seg_t:.2f}s, patch "
              f"{patch_t:.2f}s, stitch {stitch_t:.2f}s)")
        _set_status(rows, sid, "processed")
        _write_csv(csv_path, rows)
        total_seg += seg_t
        total_patch += patch_t
        done[sid] = {"patches": len(res.coords), "seg_s": seg_t,
                     "patch_s": patch_t, "stitch_s": stitch_t}
    # once more at the end: the auto-skip branch updates status only in
    # memory, so an all-skipped run would leave the CSV stale or unwritten
    _write_csv(csv_path, rows)
    n = max(len(slides), 1)
    print(f"avg seg {total_seg / n:.2f}s, avg patch {total_patch / n:.2f}s")
    return done


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("Step1: create patches (PyTorch port)")
    p.add_argument("--source", required=True, help="slide directory")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--patch_size", type=int, default=512)
    p.add_argument("--step_size", type=int, default=512)
    p.add_argument("--sthresh", type=int, default=8)
    p.add_argument("--mthresh", type=int, default=7)
    p.add_argument("--close", type=int, default=4)
    p.add_argument("--use_otsu", action="store_true")
    p.add_argument("--a_t", type=float, default=100)
    p.add_argument("--a_h", type=float, default=16)
    p.add_argument("--contour_fn", default="four_pt",
                   choices=["four_pt", "four_pt_hard", "center", "basic"])
    p.add_argument("--auto_skip", action="store_true", default=True)
    p.add_argument("--no_auto_skip", dest="auto_skip", action="store_false")
    p.add_argument("--no_stitch", action="store_true")
    p.add_argument("--coords_format", choices=["h5", "pt"], default="h5",
                   help="per-slide coords: the reference's <slide>.h5, or "
                        "<slide>.pt from wsi/tiling.py::save_coords_pt")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    return seg_and_patch(parse_args(argv))


if __name__ == "__main__":
    main()
