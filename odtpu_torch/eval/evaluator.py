"""The evaluators: run the eval step over a loader and score VOC or COCO
mAP.

Counterpart of ``odtpu/eval/evaluator.py`` ``EvalBase.validate``,
``EvalVOC``, ``EvalCOCO`` and ``eval_solver_factory``, with their
TensorBoard images: the first eval batch's detections over its inputs
under ``LOG.SHOW_TEST_IMAGE`` and VOC's per-class PR curves under
``LOG.SHOW_PR_CURVE``, written on rank 0 when a writer is given. The
eval step is
``step(images) -> {"rows": [B, R, 6], "dropped": [B]}``
(``odtpu_torch.eval_step``), or under ``EVAL.COMPACT = False`` the dense
``[B, C, K, 5]``, which :func:`dense_to_rows` turns into ``[B, C * K,
6]`` rows with no ``dropped`` count; the rows' boxes are scaled from
[0, 1] to each image's original pixels by the batch's ``extra`` (h, w, c), short
last batches are padded to the loader's batch size, and a nonzero
``dropped`` count (per-class survivors the row cap discarded) is
reported in ``last_timing`` and as a warning.

On a mesh each data index validates its slice of the test set (the
loader's shard) with no collective of the evaluator's inside the loop
(the sharded model's own run in its forward); at the end the rows are
all-gathered (``parallel.allgather_host_rows``), each at its image's
global dataset index, so that every rank scores the same mAP, and the
image and ``dropped`` counts are summed over the ranks. Every rank of a
data index holds the same rows: only its leader (``m = 0, s = 0``)
hands them over and counts them. Only rank 0 writes the detection
files.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import parallel
from ..data.loader import pad_batch_to
from .coco_eval import build_gt_index, evaluate_coco
from .voc_eval import evaluate_detections


class EvalBase:
    def __init__(self, data_loader, cfg, output_dir="eval_out"):
        self.loader = data_loader
        self.cfg = cfg
        self.output_dir = output_dir
        self.batch_size = data_loader.batch_size
        self.last_timing = {}

    def reset_results(self):
        raise NotImplementedError

    def accumulate(self, det, extra, ids, img_idx, indices=None):
        raise NotImplementedError

    def evaluate_stats(self, tb_writer=None):
        raise NotImplementedError

    def _gather_multihost(self):
        """All-gather the ranks' results (a no-op in one process)."""

    def validate(self, eval_step, tb_writer=None):
        """Run ``eval_step`` over the loader; returns (per-class results,
        [mAP]). ``tb_writer`` (a ``utils.logging.TBWriter``) takes the
        images the ``LOG.SHOW_*`` flags ask for, on rank 0."""
        if not parallel.is_main() or (tb_writer is not None
                                      and tb_writer.writer is None):
            tb_writer = None
        self.reset_results()
        img_idx = 0
        t_detect = 0.0
        t0 = time.time()
        n_images = 0
        n_dropped = 0
        for batch in self.loader:
            batch, valid = pad_batch_to(batch, self.batch_size)
            t1 = time.time()
            out = eval_step(batch["images"])
            if isinstance(out, dict):
                det = out["rows"].cpu().numpy()[:valid].copy()
                n_dropped += int(out["dropped"].cpu().numpy()[:valid].sum())
            else:  # the dense contract: every per-class survivor
                det = dense_to_rows(out.cpu().numpy()[:valid])
            t_detect += time.time() - t1
            # normalized boxes (columns 1-4) -> original pixels
            h = batch["extra"][:valid, 0].reshape(valid, 1)
            w = batch["extra"][:valid, 1].reshape(valid, 1)
            det[..., 1] *= w
            det[..., 3] *= w
            det[..., 2] *= h
            det[..., 4] *= h
            if (tb_writer is not None and self.cfg.LOG.SHOW_TEST_IMAGE
                    and img_idx == 0):
                self._log_test_images(batch, det, valid, tb_writer)
            indices = batch.get("indices")
            if indices is not None:
                indices = indices[:valid]
            img_idx = self.accumulate(det, batch["extra"][:valid],
                                      batch["ids"][:valid], img_idx,
                                      indices=indices)
            n_images += valid
        self._gather_multihost()
        if not parallel.is_data_leader():
            n_images = n_dropped = 0
        n_images, n_dropped = parallel.sum_over_ranks(n_images, n_dropped)
        total = time.time() - t0
        self.last_timing = {"detect_s": t_detect, "total_s": total,
                            "images": n_images,
                            "ips": n_images / max(total, 1e-9),
                            "dropped_dets": n_dropped}
        if n_dropped and parallel.is_main():
            cap = int(self.cfg.EVAL.COMPACT_ROWS) or int(self.cfg.EVAL.TOP_K)
            print("WARNING: the eval rows dropped {} detections beyond the "
                  "{}-per-image cross-class cap; raise EVAL.COMPACT_ROWS "
                  "(or set EVAL.COMPACT=False for the dense reference "
                  "contract)".format(n_dropped, cap), file=sys.stderr)
        return self.evaluate_stats(tb_writer)

    def _log_test_images(self, batch, det, valid, tb_writer, thresh=0.5):
        """Detections against the input of the first eval batch's first 4
        images (reference visualize_box, evaluate_utils.py:81-112): the
        ground truth in red, rows scoring above ``thresh`` in green, both
        at the network input's size, tag ``eval/detections``, step the
        image's place in the batch."""
        from ..utils.visualize import vis_img_box
        mean = np.asarray(self.cfg.DATASET.PIXEL_MEANS, np.float32)
        for b in range(min(valid, 4)):
            img = np.asarray(batch["images"][b])
            if img.dtype != np.uint8:  # undo mean-subtract + RGB flip
                img = np.clip(img[:, :, ::-1] + mean, 0, 255)
            h, w = img.shape[:2]
            rows = det[b]
            rows = rows[rows[:, 0] > thresh].copy()
            # det is in original-image pixels; rescale to network input
            oh = batch["extra"][b, 0]
            ow = batch["extra"][b, 1]
            rows[:, [1, 3]] *= w / ow
            rows[:, [2, 4]] *= h / oh
            # ground truth (normalized) -> network-input pixels
            valid_gt = batch["labels"][b] >= 0
            gt = np.concatenate(
                [batch["boxes"][b][valid_gt]
                 * np.array([w, h, w, h], np.float32),
                 batch["labels"][b][valid_gt, None].astype(np.float32) + 1],
                axis=1)
            vis_img_box(img.astype(np.uint8), {"gt": gt, "pred": rows},
                        tb_writer, tag="eval/detections", step=b)


def dense_to_rows(det: np.ndarray) -> np.ndarray:
    """[V, C, K, 5] -> [V, C * K, 6] rows (score, box, cls), as
    ``odtpu``'s ``EvalBase._dense_to_rows``."""
    V, C, K, _ = det.shape
    cls = np.broadcast_to(np.arange(C, dtype=det.dtype)[None, :, None],
                          (V, C, K))
    rows = np.concatenate([det, cls[..., None]], axis=-1)
    return rows.reshape(V, C * K, 6)


class EvalVOC(EvalBase):
    def __init__(self, data_loader, cfg, output_dir="eval_out"):
        super().__init__(data_loader, cfg, output_dir)
        if cfg.DATASET.NUM_EVAL_PICS > 0:
            raise ValueError("NUM_EVAL_PICS subsetting is not supported for "
                             "VOC (reference evaluate_utils.py:119)")
        self.test_set = cfg.DATASET.TEST_SETS[0][1]
        self.num_classes = cfg.MODEL.NUM_CLASSES

    def reset_results(self):
        n = self.loader.num_items
        self.results = [[np.zeros((0, 5), np.float32) for _ in range(n)]
                        for _ in range(self.num_classes)]

    def accumulate(self, det, extra, ids, img_idx, indices=None):
        # det [V, N, 6] rows = score, x1, y1, x2, y2, cls (pixels);
        # indices = the images' positions in the dataset
        for b in range(det.shape[0]):
            pos = int(indices[b]) if indices is not None else img_idx
            rows = det[b]
            rows = rows[rows[:, 0] > 0]
            for cls in range(1, self.num_classes):
                r = rows[rows[:, 5] == cls]
                if r.size == 0:
                    continue
                # -> x1, y1, x2, y2, score
                self.results[cls][pos] = np.ascontiguousarray(
                    r[:, [1, 2, 3, 4, 0]], np.float32)
            img_idx += 1
        return img_idx

    def _gather_multihost(self):
        if parallel.world() == 1:
            return
        chunks = []
        leader = parallel.is_data_leader()
        for cls in range(1, self.num_classes if leader else 1):
            for pos, r in enumerate(self.results[cls]):
                if r.size:
                    head = np.broadcast_to(
                        np.asarray([pos, cls], np.float32), (len(r), 2))
                    chunks.append(np.concatenate([head, r], axis=1))
        local = (np.concatenate(chunks, 0) if chunks
                 else np.zeros((0, 7), np.float32))
        merged = parallel.allgather_host_rows(local)
        self.reset_results()
        self._scatter_rows(merged)

    def _scatter_rows(self, merged):
        """Put gathered [N, 7] rows (pos, cls, x1, y1, x2, y2, score) into
        ``results[cls][pos]``: one stable sort by (cls, pos), then one
        slice a group, the incoming order kept within it (appending row
        by row would regrow each array, quadratic on a full test set)."""
        if not len(merged):
            return
        merged = np.asarray(merged, np.float32)
        merged = merged[np.lexsort((merged[:, 0], merged[:, 1]))]
        keys = merged[:, :2].astype(np.int64)
        starts = np.flatnonzero(
            np.r_[True, np.any(keys[1:] != keys[:-1], axis=1)])
        bounds = np.r_[starts, len(merged)]
        for s, e in zip(bounds[:-1], bounds[1:]):
            pos, cls = int(keys[s, 0]), int(keys[s, 1])
            self.results[cls][pos] = np.ascontiguousarray(merged[s:e, 2:])

    def evaluate_stats(self, tb_writer=None):
        res, mAP = evaluate_detections(
            self.results, self.loader.dataset, self.output_dir,
            test_set=self.test_set,
            use_07_metric=bool(self.cfg.EVAL.USE_07_METRIC),
            write_files=parallel.is_main())
        # PR curves gated like the reference (LOG.SHOW_PR_CURVE,
        # evaluate_utils.py:160)
        if tb_writer is not None and self.cfg.LOG.SHOW_PR_CURVE:
            tb_writer.add_pr_curves(res)
        return res, [mAP]


class EvalCOCO(EvalBase):
    """COCO mAP@0.5 and mAP@[.5:.95] of the first ``loader.num_items``
    images (``DATASET.NUM_EVAL_PICS``) by ``coco_eval.evaluate_coco``."""

    def __init__(self, data_loader, cfg, output_dir="eval_out"):
        super().__init__(data_loader, cfg, output_dir)
        self.label_to_cat = data_loader.dataset.label_to_cat

    def reset_results(self):
        self.rows = []

    def accumulate(self, det, extra, ids, img_idx, indices=None):
        # det [V, N, 6] rows = score, x1, y1, x2, y2, cls (pixels; cls 1-80)
        # -> [coco id, x, y, w, h, score, category id]
        for b in range(det.shape[0]):
            coco_id = float(ids[b])
            rows = det[b]
            rows = rows[rows[:, 0] > 0]
            for r in rows:
                cat = float(self.label_to_cat[int(r[5]) - 1])
                self.rows.append((coco_id, r[1], r[2], r[3] - r[1],
                                  r[4] - r[2], r[0], cat))
            img_idx += 1
        return img_idx

    def _gather_multihost(self):
        if parallel.world() == 1:
            return
        local = (np.asarray(self.rows, np.float32).reshape(-1, 7)
                 if self.rows and parallel.is_data_leader()
                 else np.zeros((0, 7), np.float32))
        self.rows = [tuple(r) for r in parallel.allgather_host_rows(local)]

    def evaluate_stats(self, tb_writer=None):
        gt_index = build_gt_index(self.loader.dataset)
        if self.loader.num_items < len(self.loader.dataset):
            keep_ids = {float(self.loader.dataset.items[i][1])
                        for i in range(self.loader.num_items)}
            gt_index = {k: v for k, v in gt_index.items()
                        if k[0] in keep_ids}
        cat_ids = sorted(self.label_to_cat.values())
        map05, map95 = evaluate_coco(self.rows, gt_index,
                                     [float(c) for c in cat_ids])
        return self.rows, [map05, map95]


def eval_solver_factory(loader, cfg, output_dir="eval_out"):
    """EvalCOCO for a COCO dataset, else EvalVOC (the reference's
    lib/utils/__init__.py:8-11)."""
    if cfg.DATASET.NAME.upper().startswith("COCO"):
        return EvalCOCO(loader, cfg, output_dir)
    return EvalVOC(loader, cfg, output_dir)
