"""Patch pixel batches for Step2, the port of ``acmil_tpu/data/
patch_dataset.py``.

:class:`SlidePatchBatches` reads coords from Step1 and pulls pixels live
from the slide, with the reference's retry at the next coarser level
(``dataset_h5.py:213-219``). A background thread reads and resizes the next
batches while the device works on the current one; every batch has the
static batch size, the last one padded with zeros and a validity count. On
a data mesh each rank reads only its rows of every batch (``shard``).
:class:`H5PatchBatches` iterates patches stored in an H5 file instead.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


def shard_rows(batch: int, index: int = 0, count: int = 1
               ) -> Tuple[slice, int]:
    """Data rank ``index`` of ``count``'s rows of a batch of ``batch``
    rows: ``(pick, rows)``, ``pick`` every ``count``-th row from ``index``
    and ``rows = ceil(batch / count)`` the block's size, rows past the
    batch's end padding. Strided rather than contiguous, so that a short
    batch (the last of a slide, or a slide smaller than a batch) still
    splits its reads evenly. ``models/encoders/build.py::gather_rows``
    interleaves the blocks back into row order."""
    return slice(index, None, count), -(-batch // count)


class H5PatchBatches:
    """Fixed-shape uint8 batches ``(imgs [batch, S, S, 3], coords,
    n_valid)`` from patches stored in an H5 file (``Whole_Slide_Bag``,
    ``dataset_h5.py:48``: an ``imgs`` dataset of pre-extracted pixels and
    ``coords``), for pipelines that materialise patches instead of reading
    slides live. ``h5py`` and ``cv2`` are imported at use."""

    def __init__(self, h5_path: str, target_size: int = 224,
                 batch_size: int = 256, imgs_key: str = "imgs"):
        import h5py

        self.h5_path = h5_path
        self.imgs_key = imgs_key
        self.target = target_size
        self.batch = batch_size
        with h5py.File(h5_path, "r") as f:
            self.n = f[imgs_key].shape[0]
            self.coords = (np.asarray(f["coords"][:]) if "coords" in f
                           else np.zeros((self.n, 2), np.int64))

    def __len__(self):
        return -(-self.n // self.batch)

    def __iter__(self):
        import h5py

        with h5py.File(self.h5_path, "r") as f:
            dset = f[self.imgs_key]
            for i in range(0, self.n, self.batch):
                chunk = np.asarray(dset[i:i + self.batch])
                n = len(chunk)
                if chunk.shape[1:3] != (self.target, self.target):
                    import cv2

                    chunk = np.stack([
                        cv2.resize(c, (self.target, self.target))
                        for c in chunk])
                out = np.zeros((self.batch, self.target, self.target, 3),
                               np.uint8)
                out[:n] = chunk[..., :3]
                yield out, self.coords[i:i + self.batch], n


class SlidePatchBatches:
    """Iterate fixed-shape uint8 patch batches ``(imgs [rows, S, S, 3],
    coords, n_valid)`` from (slide, coords).

    ``shard=(index, count)`` makes this the reader of data rank ``index``
    of ``count``: of every batch of ``batch_size`` coords it reads only
    every ``count``-th from ``index`` into a block of ``rows =
    ceil(batch_size / count)`` (:func:`shard_rows`), padding included;
    every rank yields ``len(self)`` batches."""

    def __init__(self, slide, coords: np.ndarray, patch_size_l0: int,
                 patch_level: int = 0, target_size: int = 224,
                 batch_size: int = 256, prefetch: int = 2,
                 shard: Tuple[int, int] = (0, 1)):
        self.slide = slide
        self.coords = np.asarray(coords, np.int64)
        self.patch_level = patch_level
        self.patch_size_l0 = int(patch_size_l0)
        self.target = target_size
        self.batch = batch_size
        self.prefetch = prefetch
        self.pick, self.rows = shard_rows(batch_size, *shard)

    def __len__(self):
        return -(-len(self.coords) // self.batch)

    def _read_patch(self, x: int, y: int) -> np.ndarray:
        lvl = self.patch_level
        size = max(int(self.patch_size_l0 /
                       self.slide.level_downsamples[lvl]), 1)
        try:
            img = self.slide.read_region((x, y), lvl, (size, size))
        except Exception:
            # retry at the next coarser level with halved patch size
            # (dataset_h5.py:213-219)
            lvl2 = min(lvl + 1, self.slide.level_count - 1)
            size2 = max(size // 2, 1)
            img = self.slide.read_region((x, y), lvl2, (size2, size2))
        if img.shape[0] != self.target:
            import cv2

            interp = (cv2.INTER_AREA if img.shape[0] > self.target
                      else cv2.INTER_LINEAR)
            img = cv2.resize(img, (self.target, self.target),
                             interpolation=interp)
        return img

    def _make(self, idxs) -> Tuple[np.ndarray, np.ndarray, int]:
        imgs = np.empty((self.rows, self.target, self.target, 3), np.uint8)
        n = len(idxs)
        for j, i in enumerate(idxs):
            imgs[j] = self._read_patch(*self.coords[i])
        if n < self.rows:
            imgs[n:] = 0
        return imgs, self.coords[idxs], n

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        order = np.arange(len(self.coords))
        # this reader's rows of each batch
        batches = [order[i:i + self.batch][self.pick]
                   for i in range(0, len(order), self.batch)]
        if self.prefetch <= 0:
            for b in batches:
                yield self._make(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err = []

        def worker():
            try:
                for b in batches:
                    q.put(self._make(b))
            except BaseException as e:
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
        t.join()
        if err:
            raise err[0]
