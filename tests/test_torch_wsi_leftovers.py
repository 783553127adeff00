"""Step2's WSI-I/O leftovers in the port against their JAX counterparts on
the same inputs: the annotation parsers (``wsi/annotations.py``), the
DeepZoom generator (``wsi/deepzoom.py``), the slides' scale-based interface
(``Slide.read``, ``get_slide_window_info``, ``get_thumbnail``) on image and
SPY slides, and ``data/patch_dataset.py::H5PatchBatches``.
"""

import json

import numpy as np
import pytest

from acmil_tpu.data import patch_dataset as jax_patches
from acmil_tpu.wsi import annotations as jax_ann
from acmil_tpu.wsi import deepzoom as jax_dz
from acmil_tpu.wsi import native as jax_native
from acmil_tpu.wsi import slide as jax_slide
from acmil_tpu_torch.data import patch_dataset
from acmil_tpu_torch.wsi import annotations, deepzoom, native
from acmil_tpu_torch.wsi.slide import ImageSlide
from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image

XML = """<?xml version="1.0"?>
<ASAP_Annotations><Annotations>
  <Annotation Name="small" Type="Polygon"><Coordinates>
    <Coordinate Order="0" X="10.7" Y="20.2"/>
    <Coordinate Order="1" X="40.0" Y="20.0"/>
    <Coordinate Order="2" X="40.0" Y="35.9"/>
  </Coordinates></Annotation>
  <Annotation Name="empty" Type="Polygon"><Coordinates/></Annotation>
  <Annotation Name="big" Type="Polygon"><Coordinates>
    <Coordinate Order="0" X="100.5" Y="200.1"/>
    <Coordinate Order="1" X="300.0" Y="200.0"/>
    <Coordinate Order="2" X="300.0" Y="400.0"/>
    <Coordinate Order="3" X="100.0" Y="400.0"/>
  </Coordinates></Annotation>
</Annotations></ASAP_Annotations>"""
TXT = [{"type": "Polygon", "coordinates": [[[0, 0], [50, 0], [50, 60]],
                                           [[5, 5], [500, 5], [500, 400],
                                            [5, 400]]]},
       {"type": "MultiPolygon", "coordinates": [[[1, 1], [9, 1], [9, 9]]]}]
# (location, size at level 0, scale) for Slide.read: down, up and at 1,
# across the edges
READS = (((0, 0), (512, 384), 0.25), ((100, 37), (300, 200), 1.0),
         ((1000, 700), (300, 300), 0.5), ((37, 91), (64, 48), 2.0),
         ((0, 0), (1152, 864), 0.1))


def _same_contours(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_xml_annotations_match_jax(tmp_path):
    p = tmp_path / "ann.xml"
    p.write_text(XML)
    got = annotations.load_xml_annotations(str(p))
    _same_contours(got, jax_ann.load_xml_annotations(str(p)))
    assert [len(c) for c in got] == [4, 3]            # by area, descending


@pytest.mark.parametrize("form", ["json", "literal"])
def test_txt_annotations_match_jax(tmp_path, form):
    p = tmp_path / "ann.txt"
    p.write_text(json.dumps(TXT) if form == "json" else repr(TXT))
    got = annotations.load_txt_annotations(str(p))
    _same_contours(got, jax_ann.load_txt_annotations(str(p)))
    assert len(got) == 3


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """The same 1152x864 slide as each package's ImageSlide and as one SPY
    file read by each package's reader."""
    img, _ = make_synthetic_slide_image(1152, 864, seed=5, tumor=True)
    port_img, jax_img = ImageSlide(img), jax_slide.ImageSlide(img)
    path = str(tmp_path_factory.mktemp("leftovers") / "s.spy")
    native.write_spy(path, [port_img._levels[i]
                            for i in range(port_img.level_count)],
                     tile_size=64)
    return {"image": (port_img, jax_img),
            "spy": (native.NativeSlide(path), jax_native.NativeSlide(path))}


@pytest.mark.parametrize("kind", ["image", "spy"])
def test_scale_reads_match_jax(slides, kind):
    got, want = slides[kind]
    for loc, size, scale in READS:
        a, b = got.read(loc, size, scale), want.read(loc, size, scale)
        assert a.shape == (max(int(size[1] * scale), 1),
                           max(int(size[0] * scale), 1), 3)
        np.testing.assert_array_equal(a, b, err_msg=f"{loc} {size} {scale}")
    for window, overlap in ((256, 0), (500, 100), (2000, 0)):
        assert got.get_slide_window_info(window, overlap) == \
            want.get_slide_window_info(window, overlap)
    for max_size in (1024, 600, 100):
        np.testing.assert_array_equal(got.get_thumbnail(max_size),
                                      want.get_thumbnail(max_size))


@pytest.mark.parametrize("kind", ["image", "spy"])
@pytest.mark.parametrize("tile, overlap", [(254, 1), (128, 0)])
def test_deepzoom_matches_jax(slides, kind, tile, overlap):
    got_slide, want_slide = slides[kind]
    got = deepzoom.DeepZoomGenerator(got_slide, tile, overlap)
    want = jax_dz.DeepZoomGenerator(want_slide, tile, overlap)
    assert got.level_count == want.level_count
    assert got.level_dimensions == want.level_dimensions
    assert got.level_tiles == want.level_tiles
    for level in range(got.level_count):
        cols, rows = got.level_tiles[level]
        for address in {(0, 0), (cols - 1, rows - 1), (cols // 2, 0)}:
            np.testing.assert_array_equal(
                got.get_tile(level, address), want.get_tile(level, address),
                err_msg=f"level {level} tile {address}")
    with pytest.raises(IndexError, match="out of range"):
        got.get_tile(got.level_count - 1, (99, 99))


@pytest.mark.parametrize("size", [64, 32])
def test_h5_patch_batches_match_jax(tmp_path, size):
    import h5py

    rs = np.random.RandomState(size)
    imgs = rs.randint(0, 256, (10, 64, 64, 4)).astype(np.uint8)
    path = str(tmp_path / "patches.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("imgs", data=imgs)
        f.create_dataset("coords", data=rs.randint(0, 1000, (10, 2)))
    got = list(patch_dataset.H5PatchBatches(path, target_size=size,
                                            batch_size=4))
    want = list(jax_patches.H5PatchBatches(path, target_size=size,
                                           batch_size=4))
    assert len(got) == len(want) == 3
    for (gi, gc, gn), (wi, wc, wn) in zip(got, want):
        assert gi.shape == (4, size, size, 3) and gn == wn
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
    assert [n for _, _, n in got] == [4, 4, 2]
