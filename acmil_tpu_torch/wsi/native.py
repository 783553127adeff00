"""Pyramid slide containers without a native build, the port of
``acmil_tpu/wsi/native.py`` and of the three backends of
``acmil_tpu/csrc/slideio.cpp``.

:class:`NativeSlide` dispatches on the file's suffix as ``sio_open`` does:

- ``.spy``: the repo's single-file tiled pyramid (:func:`write_spy` writes
  it), read in Python. The header and tile tables are parsed as
  ``SpySlide::open`` parses them, with the same sanity bounds and errors;
  ``read_region`` blits each covering tile's intersection into a white
  buffer, decoding the tiles on a thread pool (``cv2.imdecode`` for JPEG
  tiles, a copy for raw ones). ``cv2`` carries its own JPEG codec, so no
  libjpeg headers are needed; it is imported only where a tile is coded.
- ``.kfb``: ``libkfbslide`` through ``ctypes``, the request reassembled
  from its 256-px JPEG tiles.
- anything else: the system ``libopenslide`` through ``ctypes``, its
  premultiplied ARGB turned into RGB over white (:func:`argb_to_rgb`).

A tile that fails to decode raises ``OSError("tile decode failed")``; no
reader substitutes white for it.
"""

from __future__ import annotations

import ctypes as C
import functools
import os
import struct
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from acmil_tpu_torch.wsi.slide import Slide

SPY_MAGIC = b"SPY1"
CODEC_RAW, CODEC_JPEG = 0, 1
JPEG_QUALITY = 90
# one tile-table entry: u64 payload offset, u32 payload bytes (packed)
_TILE_ENTRY = np.dtype([("off", "<u8"), ("size", "<u4")])
KFB_TILE = 256
OPENSLIDE_LIBS = ("libopenslide.so.1", "libopenslide.so.0", "libopenslide.so")
KFB_LIBS = ("libkfbslide.so",)

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _decode_pool() -> ThreadPoolExecutor:
    """The process's tile-decode pool, ``max(2, cpu_count)`` threads
    (slideio.cpp's ``pool()``), started at the first read."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max(2, os.cpu_count() or 1),
                                       thread_name_prefix="spy-decode")
        return _pool


def _cdiv(a: int, b: int) -> int:
    """Integer division truncating toward zero, as C's ``/``."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def decode_jpeg(payload: bytes) -> Optional[np.ndarray]:
    """RGB uint8 ``[h, w, 3]`` of a JPEG, or None when it does not decode.
    EXIF orientation is ignored, as libjpeg ignores it."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(payload, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    return None if bgr is None else bgr[..., ::-1]


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """Baseline JPEG of an RGB tile at ``JPEG_QUALITY``."""
    import cv2

    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
    if not ok:
        raise OSError("jpeg encode failed")
    return buf.tobytes()


def _blit(out, lx0, ly0, rgb, gx0, gy0) -> None:
    """Copy the intersection of ``rgb`` (a tile at level coords (gx0, gy0))
    with the request window at (lx0, ly0) into ``out``."""
    h, w = out.shape[:2]
    th, tw = rgb.shape[:2]
    ix0, iy0 = max(gx0, lx0), max(gy0, ly0)
    ix1, iy1 = min(gx0 + tw, lx0 + w), min(gy0 + th, ly0 + h)
    if ix1 > ix0 and iy1 > iy0:
        out[iy0 - ly0:iy1 - ly0, ix0 - lx0:ix1 - lx0] = \
            rgb[iy0 - gy0:iy1 - gy0, ix0 - gx0:ix1 - gx0]


# ---------------------------------------------------------------------------
# SPY container
#
# layout (little endian):
#   magic "SPY1" | u32 n_levels | u32 tile_size | u32 codec
#   per level: u32 w | u32 h
#   per level: tile table (u64 offset | u32 byte_size) x (tx*ty)
#   tile payloads
# codec: 0 = raw RGB, 1 = JPEG
# ---------------------------------------------------------------------------

class _Spy:
    """An open SPY file: its levels' dims and tile tables, and one read-only
    descriptor that every read goes through with ``os.pread`` (no shared
    seek between the decode threads)."""

    def __init__(self, path: str):
        fd = os.open(path, os.O_RDONLY)
        try:
            self._parse(fd, path)
        except BaseException:
            os.close(fd)
            raise
        self.fd = fd

    def _parse(self, fd: int, path: str) -> None:
        if os.pread(fd, 4, 0) != SPY_MAGIC:
            raise OSError(f"slideio failed to open {path}: bad SPY magic")
        corrupt = OSError(f"slideio failed to open {path}: truncated or "
                          f"corrupt SPY header in {path}")
        head = os.pread(fd, 12, 4)
        if len(head) != 12:
            raise corrupt
        n_levels, tile, codec = struct.unpack("<3I", head)
        if not (1 <= n_levels <= 64 and 16 <= tile <= 16384 and codec <= 1):
            raise corrupt
        raw = os.pread(fd, 8 * n_levels, 16)
        if len(raw) != 8 * n_levels:
            raise corrupt
        dims = np.frombuffer(raw, "<u4").reshape(n_levels, 2)
        if not ((dims > 0) & (dims <= 1 << 30)).all():
            raise corrupt
        self.tile, self.codec = tile, codec
        self.dims = [(int(w), int(h)) for w, h in dims]
        self.grid = [(-(-w // tile), -(-h // tile)) for w, h in self.dims]
        size = os.fstat(fd).st_size
        pos = 16 + 8 * n_levels
        self.tables = []
        for tx, ty in self.grid:
            nbytes = tx * ty * _TILE_ENTRY.itemsize
            if pos + nbytes > size:
                raise corrupt
            self.tables.append(np.frombuffer(os.pread(fd, nbytes, pos),
                                             _TILE_ENTRY))
            pos += nbytes

    def close(self) -> None:
        os.close(self.fd)

    def level_count(self) -> int:
        return len(self.dims)

    def level_dimensions(self, level: int):
        return self.dims[level]

    def level_downsample(self, level: int) -> float:
        return self.dims[0][0] / self.dims[level][0]

    def read_region(self, x0, y0, level, w, h, out) -> None:
        """Fill ``out`` (white, ``[h, w, 3]``) from the tiles of ``level``
        covering the window at level-0 ``(x0, y0)``."""
        if not 0 <= level < len(self.dims):
            raise OSError("read_region failed: bad level")
        lw, lh = self.dims[level]
        ntx, nty = self.grid[level]
        ds = self.level_downsample(level)
        lx0, ly0 = int(x0 / ds), int(y0 / ds)
        t = self.tile
        tx0, ty0 = max(0, _cdiv(lx0, t)), max(0, _cdiv(ly0, t))
        tx1 = min(ntx - 1, _cdiv(lx0 + w - 1, t))
        ty1 = min(nty - 1, _cdiv(ly0 + h - 1, t))
        if tx1 < tx0 or ty1 < ty0:
            return                               # fully outside: stays white
        table = self.tables[level]

        def tile(tx, ty):
            entry = table[ty * ntx + tx]
            off, size = int(entry["off"]), int(entry["size"])
            if size == 0:
                return                           # empty payload: white
            payload = os.pread(self.fd, size, off)
            tw, th = min(t, lw - tx * t), min(t, lh - ty * t)
            if len(payload) != size:
                raise OSError("tile decode failed")
            if self.codec == CODEC_JPEG:
                rgb = decode_jpeg(payload)
                if rgb is None or rgb.shape[:2] != (th, tw):
                    raise OSError("tile decode failed")
            elif size == tw * th * 3:
                rgb = np.frombuffer(payload, np.uint8).reshape(th, tw, 3)
            else:
                raise OSError("tile decode failed")
            _blit(out, lx0, ly0, rgb, tx * t, ty * t)

        pool = _decode_pool()
        futures = [pool.submit(tile, tx, ty) for ty in range(ty0, ty1 + 1)
                   for tx in range(tx0, tx1 + 1)]
        errors = [f.exception() for f in futures]
        for e in errors:
            if e is not None:
                raise e


def write_spy(path: str, levels: Sequence[np.ndarray], tile_size: int = 256,
              codec: str = "jpeg") -> None:
    """Write an image pyramid (RGB uint8 arrays, level 0 first) as a SPY
    container, in ``SpyWriter``'s layout: the header, a zeroed tile table,
    the payloads appended tile by tile, then the table rewritten. JPEG
    tiles are coded at quality 90; any other ``codec`` stores raw RGB."""
    code = CODEC_JPEG if codec == "jpeg" else CODEC_RAW
    imgs = [np.ascontiguousarray(np.asarray(l)[..., :3], np.uint8)
            for l in levels]
    grids = [(-(-img.shape[1] // tile_size), -(-img.shape[0] // tile_size))
             for img in imgs]
    tables = [np.zeros(tx * ty, _TILE_ENTRY) for tx, ty in grids]
    with open(path, "wb") as f:
        f.write(SPY_MAGIC + struct.pack("<3I", len(imgs), tile_size, code))
        for img in imgs:
            f.write(struct.pack("<2I", img.shape[1], img.shape[0]))
        table_pos = f.tell()
        for table in tables:
            f.write(table.tobytes())
        for img, (tx_n, ty_n), table in zip(imgs, grids, tables):
            for ty in range(ty_n):
                for tx in range(tx_n):
                    tile = img[ty * tile_size:(ty + 1) * tile_size,
                               tx * tile_size:(tx + 1) * tile_size]
                    payload = (encode_jpeg(tile) if code == CODEC_JPEG
                               else np.ascontiguousarray(tile).tobytes())
                    table[ty * tx_n + tx] = (f.tell(), len(payload))
                    f.write(payload)
        f.seek(table_pos)
        for table in tables:
            f.write(table.tobytes())


# ---------------------------------------------------------------------------
# OpenSlide and KFB passthrough (ctypes)
# ---------------------------------------------------------------------------

@functools.cache
def load_library(names: tuple) -> Optional[C.CDLL]:
    """The first of ``names`` that loads, or None."""
    for name in names:
        try:
            return C.CDLL(name, mode=C.RTLD_GLOBAL)
        except OSError:
            continue
    return None


def argb_to_rgb(argb: np.ndarray) -> np.ndarray:
    """OpenSlide's premultiplied ARGB (uint32 ``[...]``) → RGB uint8
    ``[..., 3]`` over white, in slideio.cpp's integer arithmetic: opaque
    pixels as they are, transparent ones white, the rest un-premultiplied
    as ``min(255, c * 255 / a)`` with C's truncating division."""
    argb = np.asarray(argb, np.uint32)
    a = argb >> 24
    rgb = np.stack([(argb >> s) & 0xFF for s in (16, 8, 0)], axis=-1)
    scaled = np.minimum(255, rgb * 255 // np.maximum(a, 1)[..., None])
    out = np.where((a == 255)[..., None], rgb, scaled)
    out = np.where((a == 0)[..., None], 255, out)
    return out.astype(np.uint8)


def _bind(lib, name, restype, argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


class _LibSlide:
    """A slide opened through a C library whose functions are named
    ``{prefix}open``, ``close``, ``get_level_count``,
    ``get_level_dimensions`` and ``get_level_downsample``, as OpenSlide's
    and libkfbslide's are."""

    def __init__(self, path: str, lib, prefix: str):
        self.open_ = _bind(lib, prefix + "open", C.c_void_p, [C.c_char_p])
        self.close_ = _bind(lib, prefix + "close", None, [C.c_void_p])
        self.count = _bind(lib, prefix + "get_level_count", C.c_int32,
                           [C.c_void_p])
        self.dims_ = _bind(lib, prefix + "get_level_dimensions", None,
                           [C.c_void_p, C.c_int32, C.POINTER(C.c_int64),
                            C.POINTER(C.c_int64)])
        self.ds = _bind(lib, prefix + "get_level_downsample", C.c_double,
                        [C.c_void_p, C.c_int32])
        self.osr = self.open_(path.encode())
        if not self.osr:
            raise OSError(f"slideio failed to open {path}: {prefix}open "
                          f"failed for {path}")

    def close(self) -> None:
        self.close_(self.osr)

    def level_count(self) -> int:
        return int(self.count(self.osr))

    def level_dimensions(self, level: int):
        w, h = C.c_int64(), C.c_int64()
        self.dims_(self.osr, level, C.byref(w), C.byref(h))
        return w.value, h.value

    def level_downsample(self, level: int) -> float:
        return float(self.ds(self.osr, level))


class _OpenSlide(_LibSlide):
    def __init__(self, path: str, lib):
        self.error = _bind(lib, "openslide_get_error", C.c_char_p,
                           [C.c_void_p])
        self.read = _bind(lib, "openslide_read_region", None,
                          [C.c_void_p, C.POINTER(C.c_uint32), C.c_int64,
                           C.c_int64, C.c_int32, C.c_int64, C.c_int64])
        super().__init__(path, lib, "openslide_")
        err = self.error(self.osr)
        if err:
            self.close()
            raise OSError(f"slideio failed to open {path}: {err.decode()}")

    def read_region(self, x0, y0, level, w, h, out) -> None:
        argb = np.empty((h, w), np.uint32)
        self.read(self.osr, argb.ctypes.data_as(C.POINTER(C.c_uint32)), x0,
                  y0, level, w, h)
        out[...] = argb_to_rgb(argb)


class _Kfb(_LibSlide):
    def __init__(self, path: str, lib):
        self.read = _bind(lib, "kfbslide_read_region", C.c_bool,
                          [C.c_void_p, C.c_int32, C.c_int64, C.c_int64,
                           C.POINTER(C.c_int), C.POINTER(C.c_void_p)])
        self.free = _bind(lib, "kfb_delete_imagedata", C.c_bool,
                          [C.c_void_p])
        super().__init__(path, lib, "kfbslide_")

    def read_region(self, x0, y0, level, w, h, out) -> None:
        """``kfbslide_read_region`` returns one JPEG tile anchored at a
        256-aligned position; the request is assembled from the covering
        tiles, each freed with ``kfb_delete_imagedata``. A tile the library
        does not return is outside the slide and stays white."""
        t = KFB_TILE
        ds = self.level_downsample(level)
        lx0, ly0 = int(x0 / ds), int(y0 / ds)
        ty = _cdiv(ly0, t)
        while ty * t < ly0 + h:
            tx = _cdiv(lx0, t)
            while tx * t < lx0 + w:
                n, pix = C.c_int(0), C.c_void_p()
                if self.read(self.osr, level, tx * t, ty * t, C.byref(n),
                             C.byref(pix)) and n.value > 0:
                    try:
                        rgb = decode_jpeg(C.string_at(pix.value, n.value))
                    finally:
                        self.free(pix)
                    if rgb is None:
                        raise OSError("tile decode failed")
                    _blit(out, lx0, ly0, rgb, tx * t, ty * t)
                tx += 1
            ty += 1


def _open_backend(path: str):
    lower = path.lower()
    if lower.endswith(".spy"):
        return _Spy(path)
    names, backend, what = ((KFB_LIBS, _Kfb, "libkfbslide")
                            if lower.endswith(".kfb")
                            else (OPENSLIDE_LIBS, _OpenSlide, "libopenslide"))
    lib = load_library(names)
    if lib is None:
        raise OSError(f"slideio failed to open {path}: {what} not available "
                      f"on this system")
    return backend(path, lib)


class NativeSlide(Slide):
    """A pyramid container through its backend (SPY, KFB or OpenSlide), with
    the openslide vocabulary of :class:`~acmil_tpu_torch.wsi.slide.Slide`.
    ``close()`` (or the last reference going away) releases the file or
    library handle; a closed slide raises ``RuntimeError``."""

    def __init__(self, path: str):
        backend = _open_backend(path)
        # registered at once, so that a backend whose metadata calls raise
        # below is still closed
        self._fin = weakref.finalize(self, backend.close)
        self._backend = backend
        n = backend.level_count()
        self.level_count = n
        self.level_dimensions = [tuple(backend.level_dimensions(i))
                                 for i in range(n)]
        self.level_downsamples = [float(backend.level_downsample(i))
                                  for i in range(n)]
        self.properties = {}
        self.path = path

    def _handle(self):
        if self._backend is None:
            raise RuntimeError(f"slide {self.path!r} is closed")
        return self._backend

    def best_level_for_downsample(self, downsample: float) -> int:
        self._handle()
        return super().best_level_for_downsample(downsample)

    def read_region(self, location, level, size) -> np.ndarray:
        w, h = int(size[0]), int(size[1])
        out = np.full((h, w, 3), 255, np.uint8)
        self._handle().read_region(int(location[0]), int(location[1]),
                                   int(level), w, h, out)
        return out

    def close(self) -> None:
        fin = getattr(self, "_fin", None)
        if fin is not None and fin.alive:
            fin()            # closes the backend exactly once
        self._backend = None
