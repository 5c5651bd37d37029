"""The config values the port reads, as a plain Python tree.

Counterpart of ``odtpu/utils/config.py`` (defaults at lines 96-208)
merged with ``cfgs/base/ssd_vgg16_voc.yml``: the SSD300-VGG16 VOC07+12
configuration, for serving and training. There is no YAML reader: the
config is a Python dict, so the port needs nothing beyond the standard
library to build it.
"""

from __future__ import annotations


class AttrDict(dict):
    """dict with attribute access (cfg.MODEL.NUM_CLASSES)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


def default_cfg() -> AttrDict:
    """A fresh SSD300-VGG16 VOC config tree (derived values filled in)."""
    C = AttrDict()

    # compute dtype for the convs: "bfloat16" (the default) or "float32";
    # parameters stay f32 either way. REMAT (activation checkpointing) is
    # read only to refuse it: the port does not have it yet
    C.TPU = AttrDict(COMPUTE_DTYPE="bfloat16", REMAT=False)

    C.DATASET = AttrDict()
    C.DATASET.NAME = "VOC0712"
    C.DATASET.TEST_SETS = (("2007", "test"),)
    C.DATASET.NUM_CLASSES = 20
    C.DATASET.IMAGE_SIZE = (300, 300)  # (h, w)
    C.DATASET.PIXEL_MEANS = (104, 117, 123)  # BGR, subtracted pre-net
    C.DATASET.NUM_EVAL_PICS = 0
    # run the photometric distortion, mean subtraction and BGR -> RGB in
    # the train step on the device (the batch arrives as uint8)
    C.DATASET.DEVICE_PHOTOMETRIC = False
    # the photometric distortion at all (host or device)
    C.DATASET.PHOTOMETRIC = True

    C.MODEL = AttrDict()
    C.MODEL.BASE = "vgg16"
    C.MODEL.SSD_TYPE = "SSD"
    C.MODEL.PRIOR_TYPE = "PriorBoxSSD"
    C.MODEL.NUM_PRIOR = None  # derived: anchors per cell, per feature map
    C.MODEL.STEPS = [8, 16, 32, 64, 100, 300]
    C.MODEL.MIN_SIZES = [30, 60, 111, 162, 213, 264]
    C.MODEL.MAX_SIZES = [60, 111, 162, 213, 264, 315]
    C.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]
    C.MODEL.VARIANCE = [0.1, 0.2]
    C.MODEL.CLIP = True
    C.MODEL.FLIP = True
    C.MODEL.EXTRAS = []  # [] = the built-in spec for the image size

    C.LOSS = AttrDict()
    C.LOSS.OVERLAP_THRESH = 0.5
    C.LOSS.NEG_POS_RATIO = 3
    C.LOSS.LOC_WEIGHT = 1.0
    # read only to refuse a nonzero weight: the repulsion loss is not
    # ported yet
    C.LOSS.REPULSION_WEIGHT = 0.0

    C.TRAIN = AttrDict()
    C.TRAIN.MAX_ITER = 120000
    C.TRAIN.EVAL_ITER = 10000
    C.TRAIN.SAVE_ITER = 10000
    C.TRAIN.LOG_LOSS_ITER = 10

    C.TRAIN.OPTIMIZER = AttrDict()
    C.TRAIN.OPTIMIZER.OPTIMIZER = "sgd"
    C.TRAIN.OPTIMIZER.LR = 1e-3
    C.TRAIN.OPTIMIZER.MOMENTUM = 0.9
    C.TRAIN.OPTIMIZER.WEIGHT_DECAY = 5e-4
    C.TRAIN.OPTIMIZER.CLIP_GRAD_NORM = 0.0  # global norm; 0 disables

    C.TRAIN.LR_SCHEDULER = AttrDict()
    C.TRAIN.LR_SCHEDULER.STEPS = (80000, 100000, 120000)
    C.TRAIN.LR_SCHEDULER.GAMMA = 0.1
    C.TRAIN.LR_SCHEDULER.WARMUP_ITERS = 0

    C.EVAL = AttrDict()
    C.EVAL.TOP_K = 200
    C.EVAL.CONF_THRESH = 0.01
    C.EVAL.NMS_THRESH = 0.45
    C.EVAL.USE_07_METRIC = True
    # cross-class row budget of the compact rows; 0 = EVAL.TOP_K
    C.EVAL.COMPACT_ROWS = 0
    return update_cfg(C)


def update_cfg(c: AttrDict) -> AttrDict:
    """Fill the derived values (``odtpu.utils.config.update_cfg``)."""
    c.MODEL.NUM_CLASSES = c.DATASET.NUM_CLASSES + 1  # + background
    c.MODEL.IMAGE_SIZE = tuple(c.DATASET.IMAGE_SIZE)
    return c
