"""PASCAL VOC detection mAP (the 07 11-point metric by default).

Counterpart of ``odtpu/eval/voc_eval.py``, the standard file protocol:
per-class ``det_<set>_<cls>.txt`` files with 1-based pixel coordinates,
greedy confidence-ranked TP/FP assignment with difficult boxes excluded,
11-point interpolated AP (or the area under the PR curve). Results files
and the annotation cache go into the run's output directory, never into
the dataset tree.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

from ..data.voc import VOC_CLASSES


def parse_rec(xml_path):
    """Parse one VOC xml into [{'name', 'difficult', 'bbox'(0-based)}]."""
    import xml.etree.ElementTree as ET
    objects = []
    for obj in ET.parse(xml_path).findall("object"):
        bb = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text,
            "difficult": int(obj.find("difficult").text),
            "bbox": [int(float(bb.find(k).text)) - 1
                     for k in ("xmin", "ymin", "xmax", "ymax")],
        })
    return objects


def voc_ap(rec, prec, use_07_metric=True):
    """11-point interpolated AP (or the exact area-under-PR variant)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def eval_class(dets, gt_by_image, ovthresh=0.5, use_07_metric=True):
    """Evaluate one class.

    Args:
        dets: list of (image_id, score, x1, y1, x2, y2) — coords 0-based px.
        gt_by_image: {image_id: {'bbox': [G,4] 0-based, 'difficult': [G]}}
    Returns (rec, prec, ap); (-1,-1,-1) when the class has no detections
    (reference contract, voc_eval.py:237-240).
    """
    npos = 0
    state = {}
    for img_id, rec in gt_by_image.items():
        difficult = np.asarray(rec["difficult"], bool)
        npos += int((~difficult).sum())
        state[img_id] = {"bbox": np.asarray(rec["bbox"], float)
                         .reshape(-1, 4),
                         "difficult": difficult,
                         "det": np.zeros(len(difficult), bool)}
    if len(dets) == 0:
        return -1.0, -1.0, -1.0

    image_ids = [d[0] for d in dets]
    confidence = np.asarray([d[1] for d in dets], float)
    BB = np.asarray([d[2:6] for d in dets], float).reshape(-1, 4)
    order = np.argsort(-confidence)
    BB = BB[order]
    image_ids = [image_ids[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = state.get(image_ids[d])
        bb = BB[d]
        ovmax, jmax = -np.inf, -1
        if R is not None and R["bbox"].size > 0:
            G = R["bbox"]
            ixmin = np.maximum(G[:, 0], bb[0])
            iymin = np.maximum(G[:, 1], bb[1])
            ixmax = np.minimum(G[:, 2], bb[2])
            iymax = np.minimum(G[:, 3], bb[3])
            inters = np.maximum(ixmax - ixmin, 0) * np.maximum(
                iymax - iymin, 0)
            uni = ((bb[2] - bb[0]) * (bb[3] - bb[1]) +
                   (G[:, 2] - G[:, 0]) * (G[:, 3] - G[:, 1]) - inters)
            overlaps = inters / uni
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if not R["difficult"][jmax]:
                if not R["det"][jmax]:
                    tp[d] = 1.0
                    R["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def load_voc_gt(dataset, cache_path=None, keep_all=True):
    """Parse (and optionally cache) GT for every image in a VOCDetection
    dataset -> {img_id: [objects]} with difficult boxes kept (eval needs
    them for exclusion, unlike training)."""
    if cache_path and osp.isfile(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    recs = {}
    for i in range(len(dataset)):
        img_id = dataset.ids[i][1]
        recs[img_id] = parse_rec(dataset.anno_path(i))
    if cache_path:
        os.makedirs(osp.dirname(cache_path), exist_ok=True)
        # whole or absent to a reader: the ranks of a run share the path
        tmp = "{}.{}.tmp".format(cache_path, os.getpid())
        with open(tmp, "wb") as f:
            pickle.dump(recs, f)
        os.replace(tmp, cache_path)
    return recs


def write_results_files(results, dataset, output_dir, test_set="test",
                        classes=VOC_CLASSES):
    """Write per-class det_<set>_<cls>.txt (1-based coords) — byte
    compatible with the reference protocol (voc_eval.py:58-72)."""
    os.makedirs(output_dir, exist_ok=True)
    for cls_ind, cls in enumerate(classes):
        path = osp.join(output_dir, "det_{}_{}.txt".format(test_set, cls))
        with open(path, "w") as f:
            for im_ind in range(len(dataset)):
                dets = results[cls_ind + 1][im_ind]
                if len(dets) == 0:
                    continue
                img_id = dataset.ids[im_ind][1]
                for k in range(dets.shape[0]):
                    f.write("{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n"
                            .format(img_id, dets[k, 4], dets[k, 0] + 1,
                                    dets[k, 1] + 1, dets[k, 2] + 1,
                                    dets[k, 3] + 1))


def evaluate_detections(results, dataset, output_dir, test_set="test",
                        use_07_metric=True, classes=VOC_CLASSES,
                        write_files=True):
    """results[cls][img] = [N,5] (x1,y1,x2,y2,score) 0-based pixels.
    Returns (per-class list [(cls, ap, prec, rec)], mAP)."""
    if write_files:
        write_results_files(results, dataset, output_dir, test_set, classes)
    gt = load_voc_gt(dataset,
                     cache_path=osp.join(output_dir, "annots.pkl"))
    res, aps = [], []
    for cls_ind, cls in enumerate(classes):
        dets = []
        for im_ind in range(len(dataset)):
            arr = results[cls_ind + 1][im_ind]
            img_id = dataset.ids[im_ind][1]
            for k in range(len(arr)):
                dets.append((img_id, float(arr[k][4]), float(arr[k][0]),
                             float(arr[k][1]), float(arr[k][2]),
                             float(arr[k][3])))
        gt_cls = {}
        for i in range(len(dataset)):
            img_id = dataset.ids[i][1]
            objs = [o for o in gt[img_id] if o["name"] == cls]
            gt_cls[img_id] = {"bbox": [o["bbox"] for o in objs],
                              "difficult": [o["difficult"] for o in objs]}
        rec, prec, ap = eval_class(dets, gt_cls, 0.5, use_07_metric)
        aps.append(ap)
        res.append((cls, ap, prec, rec))
    valid = [a for a in aps if a >= 0]
    mAP = float(np.mean(valid)) if valid else 0.0
    return res, mAP
