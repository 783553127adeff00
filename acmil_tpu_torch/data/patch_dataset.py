"""Patch pixel batches for Step2, the port of ``SlidePatchBatches`` in
``acmil_tpu/data/patch_dataset.py``.

Reads coords from Step1 and pulls pixels live from the slide, with the
reference's retry at the next coarser level (``dataset_h5.py:213-219``). A
background thread reads and resizes the next batches while the device works
on the current one; every batch has the static batch size, the last one
padded with zeros and a validity count.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


class SlidePatchBatches:
    """Iterate fixed-shape uint8 patch batches ``(imgs [batch, S, S, 3],
    coords, n_valid)`` from (slide, coords)."""

    def __init__(self, slide, coords: np.ndarray, patch_size_l0: int,
                 patch_level: int = 0, target_size: int = 224,
                 batch_size: int = 256, prefetch: int = 2):
        self.slide = slide
        self.coords = np.asarray(coords, np.int64)
        self.patch_level = patch_level
        self.patch_size_l0 = int(patch_size_l0)
        self.target = target_size
        self.batch = batch_size
        self.prefetch = prefetch

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
        imgs = np.empty((self.batch, self.target, self.target, 3), np.uint8)
        n = len(idxs)
        for j, i in enumerate(idxs):
            imgs[j] = self._read_patch(*self.coords[i])
        if n < self.batch:
            imgs[n:] = 0
        return imgs, self.coords[idxs], n

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        order = np.arange(len(self.coords))
        batches = [order[i:i + self.batch]
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
