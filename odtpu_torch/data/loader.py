"""Batched, prefetching loader of fixed-shape batches.

Counterpart of ``odtpu/data/loader.py`` (pure numpy and threads):
ground truth is padded to [max_boxes] with label -1 (the matcher masks
it), worker threads prepare batches ahead, and each batch's augmentation
draws from a generator keyed by (seed, epoch, batch index), so a batch
does not depend on which thread made it. The transform is a callable the
caller passes in: ``transform(image, boxes, labels, rng=rng) -> (image,
boxes, labels)``. A uint8 image stays uint8 BGR (the device
normalizes it); a float image is flipped to RGB.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class DetLoader:
    """Iterable over dict batches:
        images  [B,H,W,3] uint8 BGR, or f32 (RGB, mean-subtracted)
        boxes   [B,M,4] f32 normalized point-form
        labels  [B,M] int32 (-1 = pad)
        extra   [B,3] f32 original (h, w, c)
        ids     list[str] length B
        indices [B] int64 global dataset indices (a sharded evaluator
                places each result at its global position)

    ``shard=(rank, world)``: data parallelism, as ``odtpu``'s loader
    shards it: every rank shuffles the whole index space alike and loads
    every ``world``-th item from its ``rank``; ``batch_size`` is then the
    rank's share of the global batch. The augmentation's generator is
    keyed by (seed, epoch, batch index), the same on every rank. With
    ``drop_last`` every rank keeps ``len // world`` items, so that all
    ranks take the same count of steps (``odtpu`` gives the first ranks
    one batch more where the remainder completes one, and a collective
    of that step would wait for the others forever); its batches are
    ``odtpu``'s otherwise.
    """

    def __init__(self, dataset, transform, batch_size, max_boxes=60,
                 shuffle=False, drop_last=False, num_workers=4, seed=0,
                 num_pics=0, shard=(0, 1)):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = int(batch_size)
        self.max_boxes = int(max_boxes)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.num_workers = max(1, int(num_workers))
        self.seed = seed
        self.epoch = 0
        self.shard = tuple(shard)
        n = len(dataset)
        self.num_items = min(n, num_pics) if num_pics else n

    def __len__(self):
        n = self._items()
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _items(self):
        """The count of items this rank loads an epoch."""
        rank, world = self.shard
        if self.drop_last:
            return self.num_items // world
        return len(range(rank, self.num_items, world))

    def _item(self, index, rng):
        rec = self.dataset[index]
        img, boxes, labels = self.transform(
            rec["image"], rec["boxes"], rec["labels"], rng=rng)
        m = self.max_boxes
        pb = np.zeros((m, 4), np.float32)
        pl = np.full((m,), -1, np.int32)
        if boxes is not None and len(boxes) > 0:
            k = min(len(boxes), m)
            pb[:k] = boxes[:k]
            pl[:k] = labels[:k]
        if img.dtype == np.uint8:
            # device-photometric path: ship raw uint8 BGR; the train step
            # handles distort + mean subtract + RGB flip on device
            img = np.ascontiguousarray(img)
        else:
            img = np.ascontiguousarray(img[:, :, ::-1],
                                       dtype=np.float32)  # -> RGB
        return img, pb, pl, rec["extra"], rec["img_id"]

    def _batches(self):
        order = np.arange(self.num_items)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        rank, world = self.shard
        order = order[rank::world][:self._items()]
        bs = self.batch_size
        for i in range(0, len(order), bs):
            chunk = order[i:i + bs]
            if len(chunk) < bs and self.drop_last:
                return
            yield chunk

    # batches prepared ahead of consumption (bounds host memory: without
    # it, fast workers would decode a whole epoch into RAM)
    PREFETCH = 8

    def __iter__(self):
        self.epoch += 1
        work: "queue.Queue" = queue.Queue()
        done: dict = {}
        lock = threading.Lock()
        cv = threading.Condition(lock)
        batches = list(self._batches())
        n = len(batches)
        ahead = min(self.PREFETCH + self.num_workers, n)
        for bi in range(ahead):
            work.put((bi, batches[bi]))
        next_to_queue = ahead
        stop = threading.Event()

        def worker(wid):
            while not stop.is_set():
                try:
                    bi, chunk = work.get(timeout=0.2)
                except queue.Empty:
                    continue  # re-check stop; more work may arrive
                # RNG keyed by (seed, epoch, batch index): augmentation
                # draws don't depend on which worker thread picked the
                # batch up — fully reproducible across runs
                rng = np.random.default_rng((self.seed, self.epoch, bi))
                try:
                    items = [self._item(int(j), rng) for j in chunk]
                    batch = {
                        "images": np.stack([it[0] for it in items]),
                        "boxes": np.stack([it[1] for it in items]),
                        "labels": np.stack([it[2] for it in items]),
                        "extra": np.stack([it[3] for it in items]),
                        "ids": [it[4] for it in items],
                        "indices": np.asarray(chunk, np.int64),
                    }
                except Exception as e:  # surface to the consumer
                    batch = e
                with cv:
                    done[bi] = batch
                    cv.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name="DetLoader-worker-{}".format(w))
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(n):
                with cv:
                    while bi not in done:
                        cv.wait(timeout=1.0)
                        if bi not in done and not any(
                                t.is_alive() for t in threads):
                            raise RuntimeError(
                                "all loader workers exited before batch "
                                "{} was produced".format(bi))
                    batch = done.pop(bi)
                if isinstance(batch, Exception):
                    raise RuntimeError(
                        "loader worker failed on batch {}".format(bi)
                    ) from batch
                if next_to_queue < n:
                    work.put((next_to_queue, batches[next_to_queue]))
                    next_to_queue += 1
                yield batch
        finally:
            stop.set()


def pad_batch_to(batch, batch_size):
    """Pad a short final batch up to batch_size by repeating row 0, and
    return (batch, valid_count) — keeps shapes static across steps."""
    n = batch["images"].shape[0]
    if n == batch_size:
        return batch, n
    reps = batch_size - n
    out = {}
    for k, v in batch.items():
        if k == "ids":
            out[k] = list(v) + [v[0]] * reps
        else:
            pad = np.repeat(v[:1], reps, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
    return out, n


class NetworkInput:
    """The transform for images that already have the network's input
    size: the uint8 image passes through (the device normalizes it), and
    any other size raises. ``augment.SSDAugmentation`` resizes."""

    def __init__(self, size):
        self.size = tuple(int(s) for s in size)

    def __call__(self, img, boxes, labels, rng=None):
        if tuple(img.shape[:2]) != self.size or img.dtype != np.uint8:
            raise ValueError("want a uint8 {} image, got {} {}; this "
                             "transform cannot resize (SSDAugmentation "
                             "does)".format(
                                 self.size, img.dtype, img.shape))
        return img, boxes, labels
