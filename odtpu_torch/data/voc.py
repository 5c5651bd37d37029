"""PASCAL VOC annotations and dataset.

Counterpart of ``odtpu/data/voc.py``: XML annotations, 1-based pixel
coordinates made 0-based and normalized to [0, 1], labels 0-19 in
alphabetical class order, difficult boxes skipped unless kept, ids from
``ImageSets/Main/<set>.txt``. Images are read by ``image.imread`` (binary
PPM without OpenCV, any other format through cv2), by a caller's
``reader(path) -> uint8 BGR [H, W, 3]`` (or None when it cannot), or
through an :class:`~odtpu_torch.data.cache.ImageCache`, which then keeps
the parsed annotations too.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from .image import imread

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

CLASS_TO_IND = {c: i for i, c in enumerate(VOC_CLASSES)}


def parse_voc_xml(path, keep_difficult=False, norm_box=True,
                  class_to_ind=None):
    """-> (boxes [N, 4] float32, labels [N] int64, difficult [N] bool)."""
    class_to_ind = class_to_ind or CLASS_TO_IND
    root = ET.parse(path).getroot()
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    boxes, labels, diffs = [], [], []
    for obj in root.iter("object"):
        difficult = int(obj.find("difficult").text) == 1
        if difficult and not keep_difficult:
            continue
        name = obj.find("name").text.lower().strip()
        bb = obj.find("bndbox")
        pts = [float(bb.find(k).text) - 1.0
               for k in ("xmin", "ymin", "xmax", "ymax")]
        if norm_box:
            pts = [pts[0] / width, pts[1] / height,
                   pts[2] / width, pts[3] / height]
        boxes.append(pts)
        labels.append(class_to_ind[name])
        diffs.append(difficult)
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64),
            np.asarray(diffs, bool))


class VOCDetection:
    """Index-based access: ``dataset[i]`` -> dict(image uint8 BGR HWC,
    boxes [N, 4] normalized point form, labels [N], extra (h, w, c),
    img_id)."""

    def __init__(self, root, image_sets=(("2007", "trainval"),
                                         ("2012", "trainval")),
                 reader=imread, keep_difficult=False,
                 dataset_name="VOC0712", image_cache=None):
        self.name = dataset_name
        self.root = root
        self.image_sets = image_sets
        self.reader = image_cache.imread if image_cache else reader
        # annotations are kept under the same opt-in as the images
        self._anno_cache = {} if image_cache is not None else None
        self.keep_difficult = keep_difficult
        self.ids = []
        for (year, setname) in image_sets:
            rootpath = osp.join(root, "VOC" + year)
            listfile = osp.join(rootpath, "ImageSets", "Main",
                                setname + ".txt")
            with open(listfile) as f:
                for line in f:
                    self.ids.append((rootpath, line.strip()))

    def __len__(self):
        return len(self.ids)

    def image_path(self, index):
        rootpath, img_id = self.ids[index]
        return osp.join(rootpath, "JPEGImages", img_id + ".jpg")

    def anno_path(self, index):
        rootpath, img_id = self.ids[index]
        return osp.join(rootpath, "Annotations", img_id + ".xml")

    def __getitem__(self, index):
        path = self.image_path(index)
        img = self.reader(path)
        if img is None:
            raise IOError("failed to read " + path)
        if self._anno_cache is not None:
            cached = self._anno_cache.get(index)
            if cached is None:
                cached = parse_voc_xml(self.anno_path(index),
                                       self.keep_difficult)
                self._anno_cache[index] = cached
            # copies out: the augmentation transforms boxes downstream
            boxes, labels = cached[0].copy(), cached[1].copy()
        else:
            boxes, labels, _ = parse_voc_xml(self.anno_path(index),
                                             self.keep_difficult)
        return {
            "image": img,
            "boxes": boxes,
            "labels": labels,
            "extra": np.asarray(img.shape, np.float32),
            "img_id": self.ids[index][1],
        }
