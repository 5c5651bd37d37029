"""COCO bbox detection mAP.

Counterpart of ``odtpu/eval/coco_eval.py`` (the reference's
``EvalCOCO.evaluate_stats``, lib/utils/evaluate_utils.py:206-222, which
runs pycocotools' COCOeval for mAP@0.5 and mAP@[.5:.95]). The protocol
is implemented here in numpy: IoU thresholds .5:.05:.95, 101-point
interpolated precision, area "all", 100 detections an image, crowd
ground truth matched but ignored. It gives (mAP@0.5, mAP@[.5:.95]).
:func:`evaluate_with_pycocotools` is ``odtpu``'s pycocotools path, kept
with its lazy import; nothing calls it, and it raises ``ImportError``
where pycocotools is not installed.

Detections are rows [coco_img_id, x, y, w, h, score, coco_cat_id] (the
reference's loadRes row format, evaluate_utils.py:199).
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = 100


def _iou_xywh(dets, gts, iscrowd):
    """IoU between det [D,4] and gt [G,4] xywh boxes; crowd GT uses
    intersection-over-det-area (pycocotools semantics). Fully
    broadcast-vectorized: one [D, G] tile, no Python loops."""
    dets = np.asarray(dets, float).reshape(-1, 4)
    gts = np.asarray(gts, float).reshape(-1, 4)
    iscrowd = np.asarray(iscrowd, bool)
    dx2 = dets[:, 0] + dets[:, 2]
    dy2 = dets[:, 1] + dets[:, 3]
    gx2 = gts[:, 0] + gts[:, 2]
    gy2 = gts[:, 1] + gts[:, 3]
    iw = (np.minimum(dx2[:, None], gx2[None, :])
          - np.maximum(dets[:, 0, None], gts[None, :, 0]))
    ih = (np.minimum(dy2[:, None], gy2[None, :])
          - np.maximum(dets[:, 1, None], gts[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    darea = (dets[:, 2] * dets[:, 3])[:, None]
    garea = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], darea, darea + garea - inter)
    return np.where(inter > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _greedy_match(ious, iscrowd, thr):
    """pycocotools evaluateImg greedy assignment for one IoU threshold.

    Dets arrive score-sorted; gts arrive non-crowd-first (stable). Per
    det the inner gt scan is one vectorized argmax with the reference's
    exact tie-breaking: later gt wins equal IoU (`< iou: continue` keeps
    scanning), and a det that can match any non-crowd gt never falls
    through to the crowd section (the `break` on reaching ignored gts).
    Returns (dtm [D], dt_ignore [D]) bool."""
    D, G = ious.shape
    gtm = np.zeros(G, bool)
    dtm = np.zeros(D, bool)
    dt_ig = np.zeros(D, bool)
    min_thr = min(thr, 1 - 1e-10)
    for d in range(D):
        avail = ~gtm | iscrowd
        iou_d = np.where(avail, ious[d], -1.0)
        cand = iou_d >= min_thr
        pool = cand & ~iscrowd
        crowd_fallback = not pool.any()
        if crowd_fallback:
            pool = cand & iscrowd
            if not pool.any():
                continue
        vals = np.where(pool, iou_d, -1.0)
        g = G - 1 - int(np.argmax(vals[::-1]))  # later gt wins ties
        dtm[d] = True
        dt_ig[d] = crowd_fallback
        gtm[g] = True
    return dtm, dt_ig


def _evaluate_img(det_rows, gt_rows):
    """Greedy matching for one (image, category) across all IoU thrs.

    det_rows: [(score, x, y, w, h)] ; gt_rows: [(x, y, w, h, iscrowd)]
    Returns (dt_scores sorted desc, dtm [T, D] matched-gt flag,
    dt_ignore [T, D], n_gt_nonignored).
    """
    det_rows = sorted(det_rows, key=lambda r: -r[0])[:MAX_DETS]
    D = len(det_rows)
    gts = sorted(gt_rows, key=lambda r: r[4])  # non-crowd first
    G = len(gts)
    iscrowd = np.array([g[4] for g in gts], bool)
    n_gt = int((~iscrowd).sum())
    T = len(IOU_THRS)
    dtm = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    if D == 0:
        return np.zeros(0), dtm, dt_ig, n_gt
    scores = np.array([r[0] for r in det_rows])
    if G == 0:
        return scores, dtm, dt_ig, n_gt
    ious = _iou_xywh(np.array([r[1:5] for r in det_rows]),
                     np.array([g[:4] for g in gts]), iscrowd)
    for t, thr in enumerate(IOU_THRS):
        dtm[t], dt_ig[t] = _greedy_match(ious, iscrowd, thr)
    return scores, dtm, dt_ig, n_gt


def evaluate_coco(det_rows, gt_index, cat_ids):
    """Native COCO bbox evaluation.

    Args:
        det_rows: array-like [N, 7]: img_id, x, y, w, h, score, cat_id.
        gt_index: {(img_id, cat_id): [(x, y, w, h, iscrowd), ...]} — must
            contain a key for every annotated (image, cat) pair; images
            come from its keys.
        cat_ids: category ids to evaluate.
    Returns:
        (mAP@0.5, mAP@[.5:.95]) floats in [0, 1].
    """
    det_rows = np.asarray(det_rows, float).reshape(-1, 7)
    img_ids = sorted({k[0] for k in gt_index})
    T, R = len(IOU_THRS), len(REC_THRS)
    precision = -np.ones((T, R, len(cat_ids)))

    dets_by = {}
    for r in det_rows:
        dets_by.setdefault((r[0], r[6]), []).append(
            (r[5], r[1], r[2], r[3], r[4]))

    for ci, cat in enumerate(cat_ids):
        all_scores, all_dtm, all_dtig = [], [], []
        n_gt = 0
        for img in img_ids:
            gt = gt_index.get((img, cat), [])
            dt = dets_by.get((img, cat), [])
            if not gt and not dt:
                continue
            s, dtm, dtig, ng = _evaluate_img(dt, gt)
            all_scores.append(s)
            all_dtm.append(dtm)
            all_dtig.append(dtig)
            n_gt += ng
        if n_gt == 0:
            continue
        if all_scores:
            scores = np.concatenate(all_scores)
            dtm = np.concatenate(all_dtm, axis=1)
            dtig = np.concatenate(all_dtig, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            dtm, dtig = dtm[:, order], dtig[:, order]
        else:
            dtm = np.zeros((T, 0), bool)
            dtig = np.zeros((T, 0), bool)
        for t in range(T):
            keep = ~dtig[t]
            tp = np.cumsum(dtm[t][keep])
            fp = np.cumsum(~dtm[t][keep])
            nd = len(tp)
            rc = tp / n_gt
            pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
            # precision envelope + 101-point sampling (pycocotools style)
            q = np.zeros(R)
            if nd:
                pr = np.maximum.accumulate(pr[::-1])[::-1]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                valid = inds < nd
                q[valid] = pr[inds[valid]]
            precision[t, :, ci] = q

    p05 = precision[0]
    map05 = float(np.mean(p05[p05 > -1])) if (p05 > -1).any() else 0.0
    pall = precision
    map95 = float(np.mean(pall[pall > -1])) if (pall > -1).any() else 0.0
    return map05, map95


def build_gt_index(dataset):
    """Build {(img_id, cat_id): [(x,y,w,h,iscrowd)]} from a COCODetection
    dataset's parsed annotations."""
    index = {}
    for (path, img_id, (w, h), anns) in dataset.items:
        for a in anns:
            key = (float(img_id), float(a["category_id"]))
            x, y, bw, bh = a["bbox"]
            index.setdefault(key, []).append(
                (x, y, bw, bh, int(a.get("iscrowd", 0))))
    return index


def evaluate_with_pycocotools(det_rows, anno_file, img_ids):
    """(mAP@0.5, mAP@[.5:.95]) of ``det_rows`` by pycocotools' COCOeval
    on the annotations of ``anno_file`` over ``img_ids``
    (``odtpu/eval/coco_eval.py:188``, the reference's
    evaluate_utils.py:206-222)."""
    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval
    coco = COCO(anno_file)
    pred = coco.loadRes(np.asarray(det_rows, float))
    e = COCOeval(coco, pred, "bbox")
    e.params.imgIds = list(img_ids)
    e.evaluate()
    e.accumulate()
    e.summarize()
    ap05 = e.eval["precision"][0, :, :, 0, 2]
    ap95 = e.eval["precision"][:, :, :, 0, 2]
    return (float(np.mean(ap05[ap05 > -1])),
            float(np.mean(ap95[ap95 > -1])))
