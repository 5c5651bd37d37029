"""Decoded images kept in host memory (opt-in: ``DATASET.CACHE_IMAGES``).

Counterpart of ``odtpu/data/cache.py``. Epochs after the first skip the
decoder: each image read through :meth:`ImageCache.imread` is stored
until the budget ``DATASET.CACHE_GB`` is spent. An image that does not
fit is not stored, and nothing is evicted (an epoch touches every image,
so a least-recently-used order would only thrash); a partial cache still
serves its hits. Callers get a copy, so a consumer that changes its
array cannot change the cache. One cache serves each dataset root
(:func:`shared_cache`): the train and eval loaders of a run share one
budget.
"""

from __future__ import annotations

import os.path as osp
import threading

from .image import imread


class ImageCache:
    def __init__(self, max_gb: float = 8.0):
        self.max_bytes = int(max_gb * (1 << 30))
        self._store = {}
        self._bytes = 0
        self._refused = 0  # images not stored for the budget
        self._lock = threading.Lock()

    def stats(self):
        return {"images": len(self._store), "bytes": self._bytes,
                "refused": self._refused}

    def imread(self, path):
        """``image.imread(path)`` through the cache: a new writable copy,
        or None (not cached) where imread gives None."""
        img = self._store.get(path)
        if img is not None:
            return img.copy()
        img = imread(path)
        if img is None:
            return img
        with self._lock:
            if path not in self._store:
                if self._bytes + img.nbytes > self.max_bytes:
                    self._refused += 1
                    return img
                # the caller owns the array it gets: store a copy
                self._store[path] = img.copy()
                self._bytes += img.nbytes
        return img


_shared = {}
_shared_lock = threading.Lock()


def shared_cache(dataset_dir, max_gb: float = 8.0) -> ImageCache:
    """The process's cache for one dataset root. The first caller for the
    root sets its budget; later callers share that cache and budget,
    whatever their ``max_gb``."""
    key = osp.abspath(dataset_dir)
    with _shared_lock:
        cache = _shared.get(key)
        if cache is None:
            _shared[key] = cache = ImageCache(max_gb)
        return cache
