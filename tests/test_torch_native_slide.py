"""The port's pyramid reader (acmil_tpu_torch/wsi/native.py, reached through
wsi/slide.py::open_slide) against the JAX package's native one
(acmil_tpu/csrc/slideio.cpp through acmil_tpu/wsi/native.py), on the same
files: each package reads the other's SPY containers, JPEG and raw.

Both packages' JPEG codecs are libjpeg at quality 90 with the default
settings, so every comparison here is exact: the pixels, the files' bytes,
and Step1's coords, Step2's features (up to the encoder's own tolerance) and
Step4's images on SPY directories.
"""

import csv
import ctypes
import os
import sys
import threading

import numpy as np
import pytest

import Step1_create_patches_fp as jax_step1
from acmil_tpu.wsi import native as jax_native
from acmil_tpu.wsi import tiling as jax_tiling
from acmil_tpu_torch.cli import step1_patches
from acmil_tpu_torch.wsi import native, tiling
from acmil_tpu_torch.wsi.slide import (ImageSlide, clear_slide_cache,
                                       open_slide)
from acmil_tpu_torch.wsi.synthetic import (make_synthetic_slide_image,
                                           write_synthetic_spy)

CODECS = ("jpeg", "raw")
# (location in level-0 px, level, (w, h)): inside, across the right and
# bottom edges, across the top-left corner, fully outside past each edge,
# straddling tiles, and at the coarser levels
REGIONS = (((0, 0), 0, (256, 256)), ((100, 37), 0, (300, 200)),
           ((1000, 700), 0, (200, 200)), ((1100, 100), 0, (300, 50)),
           ((-50, -70), 0, (120, 130)), ((5000, 5000), 0, (64, 64)),
           ((-700, 0), 0, (100, 100)), ((0, -900), 0, (100, 100)),
           ((1151, 863), 0, (1, 1)), ((513, 257), 1, (300, 200)),
           ((0, 0), 1, (600, 450)), ((-100, 300), 1, (700, 500)),
           ((37, 91), 0, (1152, 864)))


@pytest.fixture(scope="module")
def pyramid():
    """A synthetic 1152x864 slide's ImageSlide levels (two: 1152 ≥ 1024)."""
    img, _ = make_synthetic_slide_image(1152, 864, seed=3, tumor=True)
    sl = ImageSlide(img)
    return [sl._levels[i] for i in range(sl.level_count)]


@pytest.fixture(scope="module")
def spy_files(pyramid, tmp_path_factory):
    """The same pyramid written by each package, with each codec, in
    64-px tiles: {(writer, codec): path}."""
    d = tmp_path_factory.mktemp("spy")
    out = {}
    for codec in CODECS:
        for writer, write in (("jax", jax_native.write_spy),
                              ("port", native.write_spy)):
            path = str(d / f"{writer}_{codec}.spy")
            write(path, pyramid, tile_size=64, codec=codec)
            out[writer, codec] = path
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_port_reads_jax_spy_exactly(spy_files, codec):
    want, got = (jax_native.NativeSlide(spy_files["jax", codec]),
                 native.NativeSlide(spy_files["jax", codec]))
    assert got.level_count == want.level_count == 2
    assert got.level_dimensions == want.level_dimensions
    assert got.level_downsamples == want.level_downsamples
    for loc, level, size in REGIONS:
        np.testing.assert_array_equal(got.read_region(loc, level, size),
                                      want.read_region(loc, level, size),
                                      err_msg=f"{loc} {level} {size}")
    got.close()
    want.close()


@pytest.mark.parametrize("codec", CODECS)
def test_jax_reads_port_spy_exactly(spy_files, codec):
    # the files are the same bytes: cv2's encoder is libjpeg at quality 90
    # with the defaults, as the native writer's
    port_file, jax_file = spy_files["port", codec], spy_files["jax", codec]
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    want = jax_native.NativeSlide(port_file)
    got = native.NativeSlide(port_file)
    for loc, level, size in REGIONS:
        np.testing.assert_array_equal(want.read_region(loc, level, size),
                                      got.read_region(loc, level, size))


def test_raw_spy_reads_as_the_image_slide(pyramid, spy_files):
    # raw tiles hold the levels' bytes, so every region, edges and white
    # fill included, equals ImageSlide's over the same levels
    img = ImageSlide(pyramid[0])
    got = native.NativeSlide(spy_files["port", "raw"])
    assert got.level_dimensions == img.level_dimensions
    assert got.level_downsamples == img.level_downsamples
    for loc, level, size in REGIONS + (((-300, 10), 0, (100, 100)),
                                       ((-10, -300), 0, (100, 100))):
        np.testing.assert_array_equal(got.read_region(loc, level, size),
                                      img.read_region(loc, level, size),
                                      err_msg=f"{loc} {level} {size}")


def test_jpeg_spy_is_close_to_its_source(pyramid, spy_files):
    got = native.NativeSlide(spy_files["port", "jpeg"])
    for level, want in enumerate(pyramid):
        h, w = want.shape[:2]
        px = got.read_region((0, 0), level, (w, h)).astype(np.float64)
        assert np.abs(px - want).mean() < 3.0


@pytest.mark.parametrize("downsample", [0.5, 1.0, 1.5, 1.99, 2.0, 2.005,
                                        2.02, 3.0, 4.0, 64.0])
def test_best_level_matches_jax(tmp_path, downsample):
    # four levels at downsamples 1, 2, 4, 8 (a 2048-px slide)
    levels = [np.zeros((2048 >> i, 2048 >> i, 3), np.uint8) for i in range(4)]
    path = str(tmp_path / "p.spy")
    native.write_spy(path, levels, tile_size=512, codec="raw")
    got, want = native.NativeSlide(path), jax_native.NativeSlide(path)
    assert got.level_downsamples == want.level_downsamples == [1, 2, 4, 8]
    assert got.level_dimensions == want.level_dimensions
    assert (got.best_level_for_downsample(downsample)
            == want.best_level_for_downsample(downsample))


def _header(n_levels=1, tile=64, codec=1, dims=((100, 80),)):
    import struct

    return (b"SPY1" + struct.pack("<3I", n_levels, tile, codec)
            + b"".join(struct.pack("<2I", *d) for d in dims))


@pytest.mark.parametrize("data, what", [
    (b"", "bad SPY magic"), (b"SPY", "bad SPY magic"),
    (b"SPX1" + bytes(40), "bad SPY magic"),
    (b"SPY1" + bytes(3), "truncated or corrupt"),
    (_header()[:20], "truncated or corrupt"),
    (_header(), "truncated or corrupt"),                  # no tile table
    (_header() + bytes(12 * 4 - 1), "truncated or corrupt"),
    (_header(n_levels=0, dims=()), "truncated or corrupt"),
    (_header(n_levels=65, dims=((8, 8),) * 65), "truncated or corrupt"),
    (_header(tile=8), "truncated or corrupt"),
    (_header(tile=16385), "truncated or corrupt"),
    (_header(codec=2), "truncated or corrupt"),
    (_header(dims=((0, 80),)), "truncated or corrupt"),
    (_header(dims=(((1 << 30) + 1, 80),)), "truncated or corrupt")])
def test_corrupt_headers_raise_as_jax(tmp_path, data, what):
    path = str(tmp_path / "bad.spy")
    with open(path, "wb") as f:
        f.write(data)
    for reader in (native.NativeSlide, jax_native.NativeSlide):
        with pytest.raises(OSError, match=what):
            reader(path)


def test_missing_files_raise_oserror(tmp_path):
    for name in ("missing.spy", "missing.svs"):
        with pytest.raises(OSError):
            open_slide(str(tmp_path / name))
        with pytest.raises(OSError):
            jax_native.NativeSlide(str(tmp_path / name))


def test_a_tile_that_does_not_decode_raises(pyramid, tmp_path):
    path = str(tmp_path / "p.spy")
    native.write_spy(path, pyramid[:1], tile_size=64)
    slide = native.NativeSlide(path)
    entry = slide._backend.tables[0][0]
    off, size = int(entry["off"]), int(entry["size"])
    slide.close()
    with open(path, "r+b") as f:                 # break the first tile only
        f.seek(off)
        f.write(bytes(size))
    for reader in (native.NativeSlide, jax_native.NativeSlide):
        s = reader(path)
        s.read_region((64, 64), 0, (64, 64))     # another tile still reads
        with pytest.raises(OSError, match="tile decode failed"):
            s.read_region((0, 0), 0, (100, 100))


def test_raw_tile_of_the_wrong_size_raises(tmp_path):
    import struct

    path = str(tmp_path / "r.spy")
    native.write_spy(path, [np.zeros((64, 64, 3), np.uint8)], tile_size=64,
                     codec="raw")
    with open(path, "r+b") as f:                 # the table says one short
        f.seek(4 * 4 + 8 + 8)
        f.write(struct.pack("<I", 64 * 64 * 3 - 1))
    with pytest.raises(OSError, match="tile decode failed"):
        native.NativeSlide(path).read_region((0, 0), 0, (8, 8))
    with pytest.raises(OSError, match="bad level"):
        native.NativeSlide(path).read_region((0, 0), 1, (8, 8))


def test_a_closed_handle_raises(spy_files):
    slide = native.NativeSlide(spy_files["port", "jpeg"])
    fin = slide._fin
    slide.close()
    assert not fin.alive
    slide.close()                                 # twice is fine
    for call in (lambda: slide.read_region((0, 0), 0, (8, 8)),
                 lambda: slide.best_level_for_downsample(2.0)):
        with pytest.raises(RuntimeError, match="is closed"):
            call()
    assert slide.properties == {} and slide.path == spy_files["port", "jpeg"]


def test_the_last_reference_closes_the_file(spy_files):
    slide = native.NativeSlide(spy_files["port", "raw"])
    fd = slide._backend.fd
    os.fstat(fd)
    del slide
    with pytest.raises(OSError):
        os.fstat(fd)


def test_concurrent_reads_agree(spy_files):
    """Eight threads read one slide at once, each region several times;
    every read equals the single-threaded one (the decode pool is shared
    and every payload read is a positioned read)."""
    slide = native.NativeSlide(spy_files["port", "jpeg"])
    want = [slide.read_region(*r) for r in REGIONS]
    bad, switch = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def reader(seed):
        order = np.random.RandomState(seed).permutation(len(REGIONS) * 3)
        for i in order % len(REGIONS):
            if not np.array_equal(slide.read_region(*REGIONS[i]), want[i]):
                bad.append(i)

    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and bad == []


def test_open_slide_dispatches_by_suffix(spy_files, tmp_path):
    clear_slide_cache()
    s = open_slide(spy_files["port", "jpeg"])
    assert isinstance(s, native.NativeSlide)
    assert open_slide(spy_files["port", "jpeg"]) is s
    clear_slide_cache()
    with pytest.raises(RuntimeError, match="is closed"):
        s.read_region((0, 0), 0, (4, 4))


def test_write_synthetic_spy_matches_jax(tmp_path):
    from acmil_tpu.wsi.synthetic import write_synthetic_spy as jax_write

    kw = dict(width=1300, height=700, seed=5, tumor=True)
    got = write_synthetic_spy(str(tmp_path / "a" / "port.spy"), **kw)
    want = jax_write(str(tmp_path / "b" / "jax.spy"), **kw)
    assert got == want and len(got) == 1
    with open(tmp_path / "a" / "port.spy", "rb") as a, \
            open(tmp_path / "b" / "jax.spy", "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------- OpenSlide, KFB

def test_argb_to_rgb_matches_the_c_formula():
    """Every alpha, with colour values up to the alpha (premultiplied) and
    past it: opaque as is, transparent white, else min(255, c*255/a) in
    integer arithmetic."""
    a = np.repeat(np.arange(256, dtype=np.uint32), 256)
    c = np.tile(np.arange(256, dtype=np.uint32), 256)
    argb = (a << 24) | (c << 16) | (((c * 7) & 0xFF) << 8) | (255 - c)
    got = native.argb_to_rgb(argb.reshape(256, 256))

    def one(alpha, v):
        if alpha == 255:
            return v
        if alpha == 0:
            return 255
        return min(255, v * 255 // alpha)

    want = np.array([[one(int(x), int(v)) for v in
                      (c_ & 0xFF for c_ in (p >> 16, p >> 8, p))]
                     for x, p in zip(a, argb)], np.uint8).reshape(256, 256, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name, lib", [("slide.svs", "libopenslide"),
                                       ("slide.ndpi", "libopenslide"),
                                       ("slide.kfb", "libkfbslide")])
def test_an_absent_library_raises_its_message(tmp_path, monkeypatch, name,
                                              lib):
    monkeypatch.setattr(native, "load_library", lambda names: None)
    with pytest.raises(OSError, match=f"{lib} not available on this system"):
        native.NativeSlide(str(tmp_path / name))


class _Fn:
    """A Python function standing in for a ctypes one: it takes the
    ``restype`` and ``argtypes`` the backend sets."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class _FakeLib:
    """A library whose C functions are this object's ``_``-prefixed
    methods."""

    def __getattr__(self, name):
        return _Fn(getattr(self, "_" + name))


class _FakeOpenSlide(_FakeLib):
    """The openslide C functions the backend calls, over one level of
    premultiplied ARGB pixels."""

    def __init__(self, argb, error=None):
        self.argb, self.err, self.closed = argb, error, 0

    def _openslide_open(self, path):
        return 1234

    def _openslide_get_error(self, osr):
        return self.err

    def _openslide_close(self, osr):
        self.closed += 1

    def _openslide_get_level_count(self, osr):
        return 1

    def _openslide_get_level_dimensions(self, osr, level, w, h):
        h._obj.value, w._obj.value = self.argb.shape

    def _openslide_get_level_downsample(self, osr, level):
        return 1.0

    def _openslide_read_region(self, osr, buf, x, y, level, w, h):
        out = np.ctypeslib.as_array(buf, (h, w))
        out[...] = self.argb[y:y + h, x:x + w]


def test_openslide_passthrough_converts_argb(tmp_path, monkeypatch):
    rs = np.random.RandomState(0)
    argb = rs.randint(0, 2 ** 32, (20, 30), dtype=np.uint64).astype(np.uint32)
    fake = _FakeOpenSlide(argb)
    monkeypatch.setattr(native, "load_library", lambda names: fake)
    slide = native.NativeSlide(str(tmp_path / "x.svs"))
    assert slide.level_dimensions == [(30, 20)]
    got = slide.read_region((4, 3), 0, (10, 12))
    np.testing.assert_array_equal(got, native.argb_to_rgb(argb[3:15, 4:14]))
    slide.close()
    assert fake.closed == 1
    fake.err = b"unsupported format"
    with pytest.raises(OSError, match="unsupported format"):
        native.NativeSlide(str(tmp_path / "y.svs"))
    assert fake.closed == 2


class _FakeKfb(_FakeLib):
    """libkfbslide over one image: 256-px JPEG tiles, none past the edge."""

    def __init__(self, img):
        self.img, self.live, self.freed = img, {}, 0

    def _kfbslide_open(self, path):
        return 99

    def _kfbslide_close(self, osr):
        pass

    def _kfbslide_get_level_count(self, osr):
        return 1

    def _kfbslide_get_level_dimensions(self, osr, level, w, h):
        h._obj.value, w._obj.value = self.img.shape[:2]

    def _kfbslide_get_level_downsample(self, osr, level):
        return 1.0

    def _kfbslide_read_region(self, osr, level, x, y, n, pix):
        h, w = self.img.shape[:2]
        if x < 0 or y < 0 or x >= w or y >= h:
            return False
        data = native.encode_jpeg(self.img[y:y + 256, x:x + 256])
        buf = ctypes.create_string_buffer(data, len(data))
        self.live[ctypes.addressof(buf)] = buf
        n._obj.value, pix._obj.value = len(data), ctypes.addressof(buf)
        return True

    def _kfb_delete_imagedata(self, pix):
        self.freed += 1
        del self.live[pix.value]
        return True


def test_kfb_reassembles_its_jpeg_tiles(tmp_path, monkeypatch):
    img, _ = make_synthetic_slide_image(600, 520, seed=2)
    fake = _FakeKfb(img)
    monkeypatch.setattr(native, "load_library", lambda names: fake)
    slide = native.NativeSlide(str(tmp_path / "x.kfb"))
    got = slide.read_region((200, 230), 0, (350, 300))
    # the same tiles through the JPEG round trip, blitted by hand
    want = np.full((300, 350, 3), 255, np.uint8)
    for ty in range(0, 3):
        for tx in range(0, 3):
            tile = native.decode_jpeg(native.encode_jpeg(
                img[ty * 256:ty * 256 + 256, tx * 256:tx * 256 + 256]))
            native._blit(want, 200, 230, tile, tx * 256, ty * 256)
    np.testing.assert_array_equal(got, want)
    assert fake.freed == 9 and fake.live == {}
    assert np.abs(got[:290].astype(int)
                  - img[230:520, 200:550].astype(int)).mean() < 3
    assert (got[290:] == 255).all()


# ------------------------------------------------------ the CLIs on SPY

@pytest.fixture(scope="module")
def spy_dir(tmp_path_factory):
    """Two synthetic SPY slides (JPEG, 256-px tiles) written by the port."""
    d = tmp_path_factory.mktemp("spy_slides")
    for i, name in enumerate(["slide_a", "test_slide_b"]):
        write_synthetic_spy(str(d / f"{name}.spy"), 1280, 960, seed=i,
                            tumor=(i == 0))
    return d


def test_step1_on_spy_slides_matches_jax_script(spy_dir, tmp_path,
                                                monkeypatch):
    common = ["--source", str(spy_dir), "--patch_size", "224",
              "--step_size", "224", "--a_t", "1", "--a_h", "1"]
    monkeypatch.setattr(sys, "argv", ["Step1_create_patches_fp.py", *common,
                                      "--save_dir", str(tmp_path / "jax")])
    jax_step1.main()
    done = step1_patches.main(common + ["--save_dir", str(tmp_path / "port")])
    assert sorted(done) == ["slide_a.spy", "test_slide_b.spy"]
    for name in ("slide_a", "test_slide_b"):
        want_c, want_l, want_a = jax_tiling.load_coords_h5(
            str(tmp_path / "jax" / "patches" / f"{name}.h5"))
        got_c, got_l, got_a = tiling.load_coords_h5(
            str(tmp_path / "port" / "patches" / f"{name}.h5"))
        assert len(got_c) == done[f"{name}.spy"]["patches"] > 0
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_l, want_l)
        for k, v in want_a.items():
            np.testing.assert_array_equal(got_a[k], v, err_msg=k)
    with open(tmp_path / "port" / "process_list_autogen.csv") as f:
        assert [r["status"] for r in csv.DictReader(f)] == ["processed"] * 2
    clear_slide_cache()
