"""The port's Step1 slice (acmil_tpu_torch/wsi/{segment,tiling,stitch}.py,
cli/step1_patches.py, the slide handle cache) against the JAX package's
functions and ``Step1_create_patches_fp.py``, on the same synthetic slides.

Segmentation, tiling and stitching are numpy and cv2 on both sides, so every
comparison is exact.
"""

import csv
import os
import sys

import h5py
import numpy as np
import pytest

import Step1_create_patches_fp as jax_step1
from acmil_tpu.wsi import segment as jax_segment
from acmil_tpu.wsi import stitch as jax_stitch
from acmil_tpu.wsi import tiling as jax_tiling
from acmil_tpu.wsi.slide import ImageSlide as JaxImageSlide
from acmil_tpu_torch.cli import step1_patches
from acmil_tpu_torch.wsi import segment, stitch, tiling
from acmil_tpu_torch.wsi.slide import ImageSlide, clear_slide_cache, open_slide
from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image


@pytest.fixture(scope="module")
def synth():
    # the slide of tests/test_wsi.py
    img, centers = make_synthetic_slide_image(2048, 1536, seed=1, tumor=True)
    return img, centers


@pytest.fixture(scope="module")
def slides(synth):
    return ImageSlide(synth[0]), JaxImageSlide(synth[0])


def _same_contours(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _same_seg(got, want):
    _same_contours(got.contours, want.contours)
    assert len(got.holes) == len(want.holes)
    for g, w in zip(got.holes, want.holes):
        _same_contours(g, w)
    assert (got.seg_level, got.downsample) == (want.seg_level, want.downsample)


@pytest.mark.parametrize("kw", [dict(a_t=1, a_h=1), {},
                                dict(a_t=1, a_h=1, use_otsu=True, close=0),
                                dict(a_t=4, a_h=0.5, sthresh=20, mthresh=11,
                                     max_n_holes=2)])
def test_segment_tissue_matches_jax(slides, kw):
    got = segment.segment_tissue(slides[0], **kw)
    want = jax_segment.segment_tissue(slides[1], **kw)
    _same_seg(got, want)
    np.testing.assert_array_equal(got.mask, want.mask)


def test_segmentation_round_trip_matches_jax(slides, tmp_path):
    seg = segment.segment_tissue(slides[0], a_t=1, a_h=1)
    segment.save_segmentation(seg, str(tmp_path / "s.pkl"))
    _same_seg(jax_segment.load_segmentation(str(tmp_path / "s.pkl")), seg)
    _same_seg(segment.load_segmentation(str(tmp_path / "s.pkl")), seg)
    scaled = segment.scale_contours(seg.contours, seg.downsample)
    _same_contours(scaled, jax_segment.scale_contours(seg.contours,
                                                      seg.downsample))


def _annotation(coords):
    cx, cy = coords[len(coords) // 2] + 64
    return [np.array([[[cx - 200, cy - 200]], [[cx + 200, cy - 200]],
                      [[cx + 200, cy + 200]], [[cx - 200, cy + 200]]],
                     np.float64)]


@pytest.mark.parametrize("contour_fn", ["four_pt", "four_pt_hard", "center",
                                        "basic"])
@pytest.mark.parametrize("with_annotations", [False, True])
def test_tile_contours_matches_jax(slides, contour_fn, with_annotations):
    seg = segment.segment_tissue(slides[0], a_t=1, a_h=1)
    ann = None
    if with_annotations:
        plain = jax_tiling.tile_contours(slides[1], seg, patch_size=128,
                                         step_size=128)
        ann = _annotation(plain.coords)
    kw = dict(patch_size=128, step_size=96, contour_fn=contour_fn,
              annotations=ann)
    got = tiling.tile_contours(slides[0], seg, **kw)
    want = jax_tiling.tile_contours(slides[1], seg, **kw)
    assert len(got.coords) > 5
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.attrs == want.attrs
    assert (got.patch_size, got.patch_level) == (want.patch_size,
                                                 want.patch_level)
    if with_annotations:
        assert got.labels.sum() > 0


def test_tile_contours_with_holes_matches_jax():
    # a contour with a hole, and a contour smaller than the patch
    img = np.full((800, 800, 3), 120, np.uint8)
    big = np.array([[0, 0], [768, 0], [768, 768], [0, 768]],
                   np.float64).reshape(-1, 1, 2)
    hole = np.array([[256, 256], [512, 256], [512, 512], [256, 512]],
                    np.float64).reshape(-1, 1, 2)
    small = np.array([[50, 50], [150, 50], [150, 150], [50, 150]],
                     np.float64).reshape(-1, 1, 2)
    for conts, holes in (([big], [[hole]]), ([small], [[]])):
        got = tiling.tile_contours(
            ImageSlide(img), segment.SegmentationResult(conts, holes, 0, 1.0),
            patch_size=128, step_size=128, mask_scale=1.0)
        want = jax_tiling.tile_contours(
            JaxImageSlide(img),
            jax_segment.SegmentationResult(conts, holes, 0, 1.0),
            patch_size=128, step_size=128, mask_scale=1.0)
        np.testing.assert_array_equal(got.coords, want.coords)
        assert len(got.coords) >= 1


def test_coords_files_match_jax(slides, tmp_path):
    seg = segment.segment_tissue(slides[0], a_t=1, a_h=1)
    res = tiling.tile_contours(slides[0], seg, patch_size=128, step_size=128)
    tiling.save_coords_h5(str(tmp_path / "port.h5"), res, name="s")
    jax_tiling.save_coords_h5(str(tmp_path / "jax.h5"), res, name="s")
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "jax.h5") as b:
        assert set(a) == set(b) == {"coords", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k][:], b[k][:])
            assert a[k].dtype == b[k].dtype
        assert dict(a["coords"].attrs).keys() == dict(b["coords"].attrs).keys()
        for k, v in b["coords"].attrs.items():
            np.testing.assert_array_equal(a["coords"].attrs[k], v)


def test_stitch_and_vis_wsi_match_jax(slides):
    seg = segment.segment_tissue(slides[0], a_t=1, a_h=1)
    res = tiling.tile_contours(slides[0], seg, patch_size=256, step_size=256)
    for kw in (dict(canvas_max=512), dict(canvas_max=2048, draw_grid=False)):
        np.testing.assert_array_equal(
            stitch.stitch_coords(slides[0], res.coords, 256, **kw),
            jax_stitch.stitch_coords(slides[1], res.coords, 256, **kw))
    for kw in ({}, dict(vis_level=0, line_thickness=3)):
        np.testing.assert_array_equal(segment.vis_wsi(slides[0], seg, **kw),
                                      jax_segment.vis_wsi(slides[1], seg, **kw))
    white = np.full((64, 64, 3), 255, np.uint8)
    for patch in (white, np.zeros((64, 64, 3), np.uint8), slides[0]
                  .read_region((900, 700), 0, (64, 64))):
        assert stitch.is_white_patch(patch) == jax_stitch.is_white_patch(patch)
        assert stitch.is_black_patch(patch) == jax_stitch.is_black_patch(patch)


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory):
    """Two synthetic PNG slides."""
    import cv2

    d = tmp_path_factory.mktemp("step1_slides")
    for i, name in enumerate(["slide_a", "test_slide_b"]):
        img, _ = make_synthetic_slide_image(1280, 960, seed=i, tumor=(i == 0))
        cv2.imwrite(str(d / f"{name}.png"), cv2.cvtColor(img,
                                                         cv2.COLOR_RGB2BGR))
    return d


def _run_jax_step1(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["Step1_create_patches_fp.py", *argv])
    jax_step1.main()


def _csv_rows(save_dir):
    with open(os.path.join(save_dir, "process_list_autogen.csv"),
              newline="") as f:
        return list(csv.reader(f))


def test_step1_cli_matches_jax_script(slide_dir, tmp_path, monkeypatch):
    common = ["--source", str(slide_dir), "--patch_size", "224",
              "--step_size", "224", "--a_t", "1", "--a_h", "1"]
    jax_dir, h5_dir, pt_dir = (str(tmp_path / t) for t in ("jax", "h5", "pt"))
    _run_jax_step1(common + ["--save_dir", jax_dir], monkeypatch)
    done = step1_patches.main(common + ["--save_dir", h5_dir])
    step1_patches.main(common + ["--save_dir", pt_dir, "--coords_format",
                                 "pt"])
    assert sorted(done) == ["slide_a.png", "test_slide_b.png"]
    for name in ("slide_a", "test_slide_b"):
        want_c, want_l, want_a = jax_tiling.load_coords_h5(
            os.path.join(jax_dir, "patches", f"{name}.h5"))
        for got_c, got_l, got_a in (
                tiling.load_coords_h5(os.path.join(h5_dir, "patches",
                                                   f"{name}.h5")),
                tiling.load_coords_pt(os.path.join(pt_dir, "patches",
                                                   f"{name}.pt"))):
            assert len(got_c) == done[f"{name}.png"]["patches"] > 0
            np.testing.assert_array_equal(got_c, want_c)
            np.testing.assert_array_equal(got_l, want_l)
            assert got_a.keys() == want_a.keys()
            for k, v in want_a.items():
                np.testing.assert_array_equal(got_a[k], v, err_msg=k)
        for sub in ("masks", "stitches"):
            assert os.path.exists(os.path.join(h5_dir, sub, f"{name}.jpg"))
    assert _csv_rows(h5_dir) == _csv_rows(jax_dir) == [
        ["slide_id", "status", "process"], ["slide_a.png", "processed", "1"],
        ["test_slide_b.png", "processed", "1"]]
    # a second run skips both slides and says so, as the JAX script does
    _run_jax_step1(common + ["--save_dir", jax_dir], monkeypatch)
    assert step1_patches.main(common + ["--save_dir", h5_dir]) == {}
    assert _csv_rows(h5_dir) == _csv_rows(jax_dir)
    assert {r[1] for r in _csv_rows(h5_dir)[1:]} == {"already_exist"}


def test_step1_marks_a_slide_it_cannot_open(slide_dir, tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.spy").write_bytes(b"SPY")
    (src / "unreadable.png").write_bytes(b"not a png")
    common = ["--source", str(src), "--a_t", "1", "--a_h", "1"]
    _run_jax_step1(common + ["--save_dir", str(tmp_path / "jax")],
                   monkeypatch)
    step1_patches.main(common + ["--save_dir", str(tmp_path / "port")])
    assert _csv_rows(str(tmp_path / "port")) == _csv_rows(
        str(tmp_path / "jax")) == [["slide_id", "status", "process"],
                                   ["broken.spy", "failed_open", "1"],
                                   ["unreadable.png", "failed_open", "1"]]


def test_open_slide_caches_handles(slide_dir):
    clear_slide_cache()
    path = str(slide_dir / "slide_a.png")
    a, b = open_slide(path), open_slide(path)
    assert a is b
    assert open_slide(path, cache=False) is not a
    clear_slide_cache()
    assert open_slide(path) is not a
    with pytest.raises(OSError):
        open_slide(str(slide_dir / "missing.spy"))
    clear_slide_cache()


def test_slide_cache_bounds_what_it_holds():
    from acmil_tpu_torch.wsi.slide import _LRUSlideCache

    closed = []

    class Probe(ImageSlide):
        def close(self):
            closed.append(self)

    cache = _LRUSlideCache(max_open=2)
    held = Probe(np.zeros((8, 8, 3), np.uint8))
    cache.put("held", held)
    for name in ("a", "b"):
        cache.put(name, Probe(np.zeros((8, 8, 3), np.uint8)))
    # "held" was evicted but a caller still holds it: not closed
    assert cache.get("held") is None and closed == []
    cache.put("c", Probe(np.zeros((8, 8, 3), np.uint8)))
    assert len(closed) == 1 and cache.get("a") is None
    cache.clear()
    assert len(closed) == 3


def test_port_modules_import_without_optional_readers():
    """Every module of the port imports with JAX, pandas and matplotlib
    absent and with h5py, yaml, cv2 and scipy blocked: those four are
    imported only where they are used."""
    import subprocess

    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'acmil_tpu', "
            "'pandas', 'matplotlib', 'h5py', 'yaml', 'cv2', 'scipy'):\n"
            "    sys.modules[m] = None\n"
            "import pkgutil, importlib, acmil_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    acmil_tpu_torch.__path__, 'acmil_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "print(len(names))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) > 40
