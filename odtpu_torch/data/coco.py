"""MS-COCO detection dataset, parsed from the instances JSON.

Counterpart of ``odtpu/data/coco.py`` (the reference's COCODetection,
lib/datasets/coco.py:76): category ids map to contiguous labels 0-79 in
the order of the sorted ids (the reference's coco_labels.txt order), xywh
boxes become [0, 1] point form, images without annotations are dropped
(coco.py:105-106), crowd boxes are kept, and several annotation sets can
be joined (train2014 + valminusminival2014). Images are read as
``voc.VOCDetection`` reads them.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from .image import imread


class COCODetection:
    """``dataset[i]`` -> dict(image uint8 BGR, boxes [N, 4] normalized
    xyxy, labels [N] 0-79, extra (h, w, c), img_id (int COCO id))."""

    def __init__(self, root, image_sets=(("2014", "train"),),
                 dataset_name="COCO2014", anno_file_tmpl=None,
                 reader=imread, image_cache=None):
        self.name = dataset_name
        self.reader = image_cache.imread if image_cache else reader
        self.root = root
        self.items = []  # (img_path, coco_img_id, (w, h), anns)
        self.cat_to_label = None
        self.label_to_cat = None
        for (year, setname) in image_sets:
            split = setname + year
            anno = (anno_file_tmpl or osp.join(
                root, "annotations", "instances_{}.json")).format(split)
            img_dir = osp.join(root, "images", split)
            if not osp.isdir(img_dir):
                img_dir = osp.join(root, split)
            self._load_split(anno, img_dir)

    def _load_split(self, anno_path, img_dir):
        with open(anno_path) as f:
            data = json.load(f)
        if self.cat_to_label is None:
            cat_ids = sorted(c["id"] for c in data["categories"])
            self.cat_to_label = {cid: i for i, cid in enumerate(cat_ids)}
            self.label_to_cat = {i: cid for cid, i in
                                 self.cat_to_label.items()}
        by_img = {}
        for a in data["annotations"]:
            by_img.setdefault(a["image_id"], []).append(a)
        for im in data["images"]:
            anns = by_img.get(im["id"])
            if not anns:
                continue  # only annotated images (reference parity)
            path = osp.join(img_dir, im["file_name"])
            self.items.append((path, im["id"],
                               (im["width"], im["height"]), anns))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        path, img_id, (w, h), anns = self.items[index]
        img = self.reader(path)
        if img is None:
            raise IOError("failed to read " + path)
        boxes, labels = [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            boxes.append([x / w, y / h, (x + bw) / w, (y + bh) / h])
            labels.append(self.cat_to_label[a["category_id"]])
        return {
            "image": img,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "extra": np.asarray(img.shape, np.float32),
            "img_id": img_id,
        }
