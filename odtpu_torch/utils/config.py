"""The config values the port reads, as a plain Python tree.

Counterpart of ``odtpu/utils/config.py`` (defaults at lines 96-208)
merged with ``cfgs/base/ssd_vgg16_voc.yml``: the SSD300-VGG16 VOC07+12
configuration, for serving, training and the data path. :func:`load_cfg`
gives each committed family yml by its name. There is no YAML reader:
each configuration is a Python dict, so the port needs nothing beyond
the standard library to build it.
"""

from __future__ import annotations

import copy
import os.path as osp


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
    return update_cfg(_defaults())


def _defaults() -> AttrDict:
    C = AttrDict()

    # the checkout's root; runs write under weights/ and logs/ there
    C.GENERAL = AttrDict()
    C.GENERAL.ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), "..",
                                              ".."))
    C.GENERAL.WEIGHTS_ROOT = osp.join(C.GENERAL.ROOT_DIR, "weights")

    # TensorBoard's root. Each SHOW_* flag needs utils/visualize.py or the
    # PR curves, which are not ported: the command lines refuse them
    C.LOG = AttrDict()
    C.LOG.ROOT_DIR = osp.join(C.GENERAL.ROOT_DIR, "logs")
    C.LOG.SHOW_PR_CURVE = False
    C.LOG.SHOW_TEST_IMAGE = False
    C.LOG.SHOW_AUG_STEPS = False
    C.LOG.SHOW_ANCHOR_MAPS = False
    C.LOG.SHOW_SALIENCY = False

    # compute dtype for the convs: "bfloat16" (the default) or "float32";
    # parameters stay f32 either way. REMAT checkpoints the train step's
    # whole model forward and recomputes it in the backward. QUANT is the
    # serving compute of the eval step: "" (off) or "int8", dynamic
    # per-image activation and per-channel weight quantization onto the
    # s8 tensor cores (ops/quant.py); training is unaffected, and any
    # float32 checkpoint serves int8 as it is
    C.TPU = AttrDict(COMPUTE_DTYPE="bfloat16", REMAT=False, QUANT="")

    C.DATASET = AttrDict()
    C.DATASET.NAME = "VOC0712"
    C.DATASET.SUB_DIR = "VOCdevkit"
    # "" = ROOT_DIR/data/SUB_DIR (update_cfg); an explicit path is kept
    C.DATASET.DATASET_DIR = ""
    C.DATASET.TRAIN_SETS = (("2007", "trainval"), ("2012", "trainval"))
    C.DATASET.TEST_SETS = (("2007", "test"),)
    C.DATASET.NUM_CLASSES = 20
    C.DATASET.IMAGE_SIZE = (300, 300)  # (h, w)
    C.DATASET.PIXEL_MEANS = (104, 117, 123)  # BGR, subtracted pre-net
    C.DATASET.TRAIN_BATCH_SIZE = 32
    C.DATASET.EVAL_BATCH_SIZE = 32
    C.DATASET.NUM_WORKERS = 8  # loader threads
    C.DATASET.NUM_EVAL_PICS = 0
    # ground truth is padded to this many boxes an image (label -1)
    C.DATASET.MAX_BOXES = 60
    # keep decoded images in host memory, up to CACHE_GB (data/cache.py)
    C.DATASET.CACHE_IMAGES = False
    C.DATASET.CACHE_GB = 8.0
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
    C.MODEL.BATCH_NORM = False  # VGG16-BN

    C.LOSS = AttrDict()
    C.LOSS.OVERLAP_THRESH = 0.5
    C.LOSS.NEG_POS_RATIO = 3
    C.LOSS.LOC_WEIGHT = 1.0
    # the repulsion loss (RepGT) is added at this weight; 0 = off
    C.LOSS.REPULSION_WEIGHT = 0.0
    # RefineDet: the ODM matches against the raw anchor grid, with no
    # negative-anchor filtering, for this many first updates, then
    # against the ARM-refined anchors; 0 = refined from the start
    C.LOSS.ODM_MATCH_WARM_ITERS = 0

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
    return C


def update_cfg(c: AttrDict) -> AttrDict:
    """Fill the derived values (``odtpu.utils.config.update_cfg``):
    ``DATASET.DATASET_DIR`` only where it is empty."""
    if not c.DATASET.DATASET_DIR:
        c.DATASET.DATASET_DIR = osp.abspath(
            osp.join(c.GENERAL.ROOT_DIR, "data", c.DATASET.SUB_DIR))
    c.MODEL.NUM_CLASSES = c.DATASET.NUM_CLASSES + 1  # + background
    c.MODEL.IMAGE_SIZE = tuple(c.DATASET.IMAGE_SIZE)
    return c


# SSD512's prior spec, shared by its VOC, COCO and RFBNet512 ymls
_IMAGE512 = dict(STEPS=[8, 16, 32, 64, 128, 256, 512],
                 ASPECT_RATIOS=[[2], [2, 3], [2, 3], [2, 3], [2, 3], [2],
                                [2]],
                 MIN_SIZES=[35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8],
                 MAX_SIZES=[76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6])
_COCO = dict(NAME="COCO2014", SUB_DIR="coco", TRAIN_SETS=(("2014", "train"),),
             TEST_SETS=(("2014", "minival"),), NUM_CLASSES=80,
             EVAL_BATCH_SIZE=32, NUM_EVAL_PICS=1024)
_COCO_TRAIN = dict(MAX_ITER=400000, EVAL_ITER=40000, SAVE_ITER=10000,
                   LR_SCHEDULER=dict(STEPS=(280000, 360000, 400000)))

# name -> (the yml it stands for, what it sets over the defaults)
CFGS = {
    "ssd_vgg16_voc": ("cfgs/base/ssd_vgg16_voc.yml", {}),
    "ssd_vgg16_coco": ("cfgs/base/ssd_vgg16_coco.yml",
                       dict(DATASET=_COCO, TRAIN=_COCO_TRAIN)),
    "ssd_vgg16_coco_image512": (
        "cfgs/base/ssd_vgg16_coco_image512.yml",
        dict(DATASET=dict(_COCO, TRAIN_SETS=("valminusminival2014",
                                             "train2014"),
                          TEST_SETS=("minival2014",), IMAGE_SIZE=(512, 512)),
             MODEL=dict(_IMAGE512, MIN_SIZES=[20.48, 51.2, 133.12, 215.04,
                                              296.96, 378.88, 460.8],
                        MAX_SIZES=[51.2, 133.12, 215.04, 296.96, 378.88,
                                   460.8, 542.72]),
             TRAIN=_COCO_TRAIN, EVAL=dict(COMPACT_ROWS=400))),
    "ssd_vgg16_voc_image512": (
        "cfgs/vgg/ssd_vgg16_voc_image512.yml",
        dict(DATASET=dict(IMAGE_SIZE=(512, 512)), MODEL=_IMAGE512,
             EVAL=dict(COMPACT_ROWS=400))),
    "fpn_vgg16_voc": ("cfgs/vgg/fpn_vgg16_voc.yml",
                      dict(MODEL=dict(SSD_TYPE="FPN"))),
    "fssd_vgg16_voc": ("cfgs/fssd/fssd_vgg16_voc.yml",
                       dict(MODEL=dict(SSD_TYPE="FSSD"))),
    "rfbnet300_vgg16_voc": (
        "cfgs/rfb/rfbnet300_vgg16_voc.yml",
        dict(MODEL=dict(SSD_TYPE="RFBNet", ASPECT_RATIOS=[
            [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]]))),
    "rfbnet512_vgg16_voc": (
        "cfgs/rfb/rfbnet512_vgg16_voc.yml",
        dict(DATASET=dict(IMAGE_SIZE=(512, 512)),
             MODEL=dict(_IMAGE512, SSD_TYPE="RFBNet", ASPECT_RATIOS=[
                 [2, 3], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]]))),
    "ssd_drn22_voc": ("cfgs/drn/ssd_drn22_voc.yml",
                      dict(MODEL=dict(BASE="drn_d_22"))),
    "ssd_drn24_voc": ("cfgs/drn/ssd_drn24_voc.yml",
                      dict(MODEL=dict(BASE="drn_d_24"))),
    # no yml: odtpu builds DRN_SSD only from code (tests/test_model_zoo.py)
    "drnssd_drn22_voc": (None, dict(MODEL=dict(SSD_TYPE="DRN_SSD",
                                               BASE="drn_d_22"))),
    "refinedet320_vgg16_voc": (
        "cfgs/refinedet/refinedet320_vgg16_voc.yml",
        dict(DATASET=dict(IMAGE_SIZE=(320, 320)),
             MODEL=dict(SSD_TYPE="RefineDet", STEPS=[8, 16, 32, 64],
                        MIN_SIZES=[32, 64, 128, 256], MAX_SIZES=[],
                        ASPECT_RATIOS=[[2], [2], [2], [2]]))),
}


def _merge(overlay: dict, into: AttrDict, where: str = "") -> None:
    for key, value in overlay.items():
        if key not in into:
            raise KeyError("no config key {}{}".format(where, key))
        if isinstance(value, dict):
            _merge(value, into[key], where + key + ".")
        else:
            into[key] = copy.deepcopy(value)


def load_cfg(name: str = "ssd_vgg16_voc") -> AttrDict:
    """A fresh config tree for one of :data:`CFGS` (derived values filled
    in): the defaults with that yml's values over them."""
    if name not in CFGS:
        raise KeyError("unknown config {!r}; known: {}".format(
            name, sorted(CFGS)))
    c = _defaults()
    _merge(CFGS[name][1], c)
    return update_cfg(c)


def resolve_cfg_args(args) -> str:
    """The :data:`CFGS` name the command lines' ``args`` ask for; fills
    ``args.cfg_name`` and ``args.job_group``, the run's name, as
    ``odtpu.utils.config.resolve_cfg_args`` does.

    ``--cfg`` names a yml by its path (``cfgs/<group>/<name>.yml``, from
    the checkout's root or the current directory): it must be one that
    ``CFGS`` stands for, since the port reads no yaml. The run is named
    after it unless ``--cfg_name``/``--job_group`` are given. Without
    ``--cfg``, ``--cfg_name`` (default ssd_vgg16_voc) picks the entry of
    ``CFGS`` and ``--job_group`` (default base) only names the run.
    """
    if getattr(args, "cfg", ""):
        parts = osp.normpath(osp.abspath(args.cfg)).split(osp.sep)
        names = [n for n, (yml, _) in CFGS.items()
                 if yml and parts[-3:] == yml.split("/")]
        if not names:
            raise SystemExit(
                "--cfg {}: not a yml that odtpu_torch.utils.config.CFGS "
                "stands for ({}); the port reads no yaml".format(
                    args.cfg, ", ".join(y for y, _ in CFGS.values() if y)))
        if not getattr(args, "cfg_name", ""):
            args.cfg_name = osp.splitext(parts[-1])[0]
        if not getattr(args, "job_group", ""):
            args.job_group = parts[-2]
        name = names[0]
    else:
        args.cfg_name = getattr(args, "cfg_name", "") or "ssd_vgg16_voc"
        args.job_group = getattr(args, "job_group", "") or "base"
        if args.cfg_name not in CFGS:
            raise SystemExit("--cfg_name {}: not one of {}".format(
                args.cfg_name, ", ".join(sorted(CFGS))))
        name = args.cfg_name
    data = CFGS[name][1].get("DATASET", {})
    flat = [s for k in ("TRAIN_SETS", "TEST_SETS") for s in data.get(k, ())
            if isinstance(s, str)]
    if flat:
        raise SystemExit(
            "{}: its yml names data sets as {}, where the datasets take "
            "(year, set) pairs; odtpu reads that yml the same way".format(
                name, flat))
    return name
