"""Bucketed bag loader with background prefetch, the port of
``acmil_tpu/data/loader.py``.

- batches are grouped by bucketed pad length (see :func:`bags.bucket_plan`);
- a background thread reads and collates on the host while the device works,
  into pinned memory when the device is CUDA, and each batch is copied with
  ``non_blocking=True`` to the loader's ``device``;
- ``cache_device=True`` keeps every batch resident on the device after the
  first pass, for eval loaders that are scored again and again;
- with a ``mesh`` (``parallel/mesh.py``), every rank builds the same plan
  from the seed, pads a ragged batch to ``batch_size`` with all-False rows
  of label 0, and keeps its rows of the batch and its slice of N
  (``shard_bag``), cut on the host before the copy to its device;
- :meth:`BagLoader.device_groups` stacks same-shape batches on a new leading
  axis, resident on the device, for the scanned epochs of
  ``engine/train.py``; on a mesh each rank stacks its part of every batch,
  grouped by the global batch's shape, so every rank holds the same groups
  in the same order.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from acmil_tpu_torch.data.bags import Bag, bucket_plan, collate_bags
from acmil_tpu_torch.parallel.mesh import shard_bag


class BagLoader:
    def __init__(
        self,
        source,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        min_bucket: int = 256,
        max_patches: int = 65536,
        seed: int = 0,
        prefetch: int = 2,
        dtype=np.float32,
        cache_device: bool = False,
        device="cpu",
        mesh=None,
    ):
        if mesh is not None and batch_size % mesh.data:
            # (the JAX loader checks this in device_groups)
            raise ValueError(f"a mesh needs B ({batch_size}) divisible by "
                             f"the data axis ({mesh.data}): each data rank "
                             f"takes B / data slides of every batch, and of "
                             f"every stacked group of the scan epochs")
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.min_bucket = min_bucket
        self.max_patches = max_patches
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.dtype = dtype
        # cache_device + shuffle: batches are built (and placed on device)
        # once; epochs replay them in a fresh random ORDER
        self.cache_device = cache_device
        self.device = torch.device(device)
        self.mesh = mesh
        self._device_batches: Optional[List[Bag]] = None
        self._device_groups: Optional[List[Bag]] = None

    # -- batch plan ---------------------------------------------------------
    def _plan(self, shuffle: Optional[bool] = None) -> List[List[int]]:
        lengths = self.source.lengths() if hasattr(self.source, "lengths") else [
            len(self.source[i]["input"]) for i in range(len(self.source))
        ]
        groups = bucket_plan(lengths, self.batch_size, self.min_bucket, self.max_patches)
        if self.drop_last:
            groups = [g for g in groups if len(g) == self.batch_size]
        shuffle = self.shuffle if shuffle is None else shuffle
        if shuffle:
            for g in groups:
                self.rng.shuffle(g)
            order = self.rng.permutation(len(groups))
            groups = [groups[i] for i in order]
        return groups

    def __len__(self) -> int:
        # shuffle=False: len() must not consume self.rng
        return len(self._plan(shuffle=False))

    # -- collation ----------------------------------------------------------
    def _collate(self, idxs: List[int]) -> Bag:
        """Host side: read and collate (on a mesh, this rank's part),
        pinned when bound for a GPU."""
        return self._local(self._collate_whole(idxs))

    def _collate_whole(self, idxs: List[int]) -> Bag:
        """The global batch of ``idxs``, on a mesh padded to ``batch_size``."""
        items = [self.source[i] for i in idxs]
        feats = [it["input"] for it in items]
        coords = [it.get("coords") for it in items]
        labels = [it["label"] for it in items]
        n_real = len(items)
        if self.mesh is not None:
            # a ragged batch is padded to a full one: rows of one zero patch,
            # masked below, label 0
            while len(feats) < self.batch_size:
                feats.append(np.zeros_like(np.asarray(feats[0][:1])))
                coords.append(None)
                labels.append(0)
        bag = collate_bags(feats, coords, labels, self.min_bucket,
                           self.max_patches, dtype=self.dtype)
        if self.mesh is not None:
            bag.mask[n_real:] = False
        return bag

    def _local(self, bag: Bag) -> Bag:
        """This rank's rows and seq slice of a global batch, pinned when
        bound for a GPU."""
        if self.mesh is not None:
            bag = shard_bag(bag, self.mesh, shard_seq=self.mesh.seq > 1)
            bag = Bag(*(t.contiguous() for t in bag._fields()))
        return bag.pin_memory() if self.device.type == "cuda" else bag

    def _to_device(self, bag: Bag) -> Bag:
        return bag.to(self.device, non_blocking=True)

    # -- stacked shape groups (scanned epochs) -------------------------------
    def device_groups(self) -> List[Bag]:
        """Same-shape batches stacked along a new leading axis, resident on
        the loader's device: the input of the scanned epochs
        (``engine/train.py::train_one_epoch_scanned`` and
        ``evaluate_scanned``). Built once, grouped by the batch's
        ``(feats.shape, dtype)`` in first-seen order over one plan, which
        draws from ``self.rng`` as the JAX loader's does, so one seed gives
        the groups and the later permutations of the JAX package. Epochs
        visit the groups, and the bags within a group, in fresh random
        orders when ``shuffle`` is set.

        On a mesh every rank builds the same plan from the seed and stacks
        its part of each batch (``_collate``: a ragged batch padded to
        ``batch_size``, this rank's rows and, at seq > 1, its slice of N),
        keyed by the global batch's shape: every rank holds the same groups
        in the same order, so the later permutations of ``self.rng`` agree
        across ranks."""
        if self._device_groups is None:
            by_shape: dict = {}
            for g in self._plan():
                whole = self._collate_whole(g)
                key = (tuple(whole.feats.shape), str(whole.feats.dtype))
                by_shape.setdefault(key, []).append(self._local(whole))
            self._device_groups = [
                Bag(*(torch.stack(ts).to(self.device)
                      for ts in zip(*(b._fields() for b in bs))))
                for bs in by_shape.values()]
        return self._device_groups

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[Bag]:
        if self.cache_device:
            if self._device_batches is None:
                self._device_batches = [self._to_device(self._collate(g))
                                        for g in self._plan()]
            order = (self.rng.permutation(len(self._device_batches))
                     if self.shuffle else range(len(self._device_batches)))
            for i in order:
                yield self._device_batches[i]
            return
        groups = self._plan()
        if self.prefetch <= 0:
            for g in groups:
                yield self._to_device(self._collate(g))
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: List[BaseException] = []
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer abandoned the
            # iterator — a plain q.put would block this thread forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for g in groups:
                    if not _put(self._collate(g)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                _put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield self._to_device(item)
        finally:
            # runs on exhaustion AND on abandonment (GeneratorExit) or an
            # exception escaping the consuming loop
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)
        if err:
            raise err[0]
