"""The config tree the port reads: Python defaults with a yml laid over
them.

Counterpart of ``odtpu/utils/config.py``: the defaults (lines 42-208,
the same keys), ``merge_cfg_from_file`` and its strict overlay (an
unknown key is an error, values are coerced to the default's type, a
string is ``literal_eval``-ed), ``load_cfg`` and ``resolve_cfg_args``.
The yml is read by the port's own reader (``utils.yml``), which gives
what ``yaml.safe_load`` gives for the YAML configs use, so the port
needs nothing beyond the standard library to read any yml ``odtpu``
reads. :data:`CFGS` names the committed configurations by their ymls
under the checkout's ``cfgs/``.
"""

from __future__ import annotations

import copy
import os.path as osp
from ast import literal_eval

import numpy as np

from . import yml


class AttrDict(dict):
    """dict with attribute access (cfg.MODEL.NUM_CLASSES)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


# the checkout's root, found from this file: the committed ymls are read
# from its cfgs/, whatever the working directory
ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), "..", ".."))


def default_cfg() -> AttrDict:
    """A fresh SSD300-VGG16 VOC config tree (derived values filled in)."""
    return update_cfg(_defaults())


def _defaults() -> AttrDict:
    C = AttrDict()

    # the checkout's root; runs write under weights/ and logs/ there
    C.GENERAL = AttrDict()
    C.GENERAL.ROOT_DIR = ROOT_DIR
    # read by no code of either package; a yml may set them
    C.GENERAL.CFG_ROOT = osp.join(C.GENERAL.ROOT_DIR, "cfgs")
    C.GENERAL.JOB_GROUP = "base"
    C.GENERAL.WEIGHTS_ROOT = osp.join(C.GENERAL.ROOT_DIR, "weights")
    # where a finished run's config and TensorBoard logs are archived
    C.GENERAL.HISTORY_ROOT = osp.join(C.GENERAL.ROOT_DIR, "history")

    # TensorBoard's root, and the images each SHOW_* flag logs there
    # (utils/visualize.py; saliency through python -m odtpu_torch.train_debug)
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
    # float32 checkpoint serves int8 as it is. MESH_* are odtpu's mesh
    # axes over the processes of a run (``parallel.make_mesh``): MESH_DATA
    # data indices (-1: what the other two leave), MESH_MODEL ranks that
    # split each wide conv's output channels, MESH_SPATIAL ranks that
    # split every map's rows (``check_mesh``)
    C.TPU = AttrDict(COMPUTE_DTYPE="bfloat16", REMAT=False, QUANT="",
                     MESH_DATA=-1, MESH_MODEL=1, MESH_SPATIAL=1)

    C.DATASET = AttrDict()
    C.DATASET.NAME = "VOC0712"
    C.DATASET.SUB_DIR = "VOCdevkit"
    # "" = ROOT_DIR/data/SUB_DIR (update_cfg); an explicit path is kept
    C.DATASET.DATASET_DIR = ""
    C.DATASET.TRAIN_SETS = (("2007", "trainval"), ("2012", "trainval"))
    C.DATASET.TEST_SETS = (("2007", "test"),)
    C.DATASET.NUM_CLASSES = 20
    C.DATASET.IMAGE_SIZE = (300, 300)  # (h, w)
    C.DATASET.PROB = 0.6  # read by no code of either package
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
    C.MODEL.NUM_CLASSES = 21  # derived: DATASET.NUM_CLASSES + background
    C.MODEL.IMAGE_SIZE = (300, 300)  # derived: DATASET.IMAGE_SIZE
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
    # read by no code of either package (the command lines take
    # --auto_resume and --basenet); a yml may set them
    C.TRAIN.RESUME = ""
    C.TRAIN.BASENET_WEIGHTS = ""

    C.TRAIN.OPTIMIZER = AttrDict()
    C.TRAIN.OPTIMIZER.OPTIMIZER = "sgd"
    C.TRAIN.OPTIMIZER.LR = 1e-3
    C.TRAIN.OPTIMIZER.MOMENTUM = 0.9
    C.TRAIN.OPTIMIZER.WEIGHT_DECAY = 5e-4
    C.TRAIN.OPTIMIZER.CLIP_GRAD_NORM = 0.0  # global norm; 0 disables

    C.TRAIN.LR_SCHEDULER = AttrDict()
    C.TRAIN.LR_SCHEDULER.SCHEDULER = "step"  # the only one there is
    C.TRAIN.LR_SCHEDULER.STEPS = (80000, 100000, 120000)
    C.TRAIN.LR_SCHEDULER.GAMMA = 0.1
    C.TRAIN.LR_SCHEDULER.WARMUP_ITERS = 0

    C.EVAL = AttrDict()
    C.EVAL.TOP_K = 200
    C.EVAL.CONF_THRESH = 0.01
    C.EVAL.NMS_THRESH = 0.45
    C.EVAL.USE_07_METRIC = True
    # the eval step's result: the cross-class rows [B, R, 6] with the
    # ``dropped`` self-audit (True), or the dense reference contract
    # [B, C, TOP_K, 5] with every per-class survivor (False)
    C.EVAL.COMPACT = True
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
    check_mesh(c)
    return c


def check_mesh(c: AttrDict) -> None:
    """Validate the mesh axes: ``TPU.MESH_MODEL`` and ``TPU.MESH_SPATIAL``
    positive integers (-1 and None mean 1, as in odtpu), ``MESH_DATA`` a
    positive integer or -1/None (whatever the other two leave). Whether
    they make up the world is ``parallel.make_mesh``'s check."""
    for key in ("MESH_DATA", "MESH_MODEL", "MESH_SPATIAL"):
        value = c.TPU[key]
        if value in (None, -1):
            continue
        if isinstance(value, bool) or not isinstance(value, int) \
                or value < 1:
            raise ValueError("TPU.{} = {!r}: want a positive integer, or "
                             "-1".format(key, value))


def refuse_mesh(c: AttrDict, entry: str) -> None:
    """Raise when ``c`` asks an entry point that runs in one process
    (``entry``) for a mesh: ``TPU.MESH_MODEL`` or ``MESH_SPATIAL`` above
    1 needs the processes of ``python -m torch.distributed.run``."""
    for key in ("MESH_MODEL", "MESH_SPATIAL"):
        value = c.TPU[key]
        if value not in (None, -1, 1):
            raise ValueError(
                "TPU.{} = {}: {} runs in one process; a tensor-parallel or "
                "spatial mesh runs under python -m torch.distributed.run "
                "with odtpu_torch.train or odtpu_torch.eval --multihost"
                .format(key, value, entry))


# name -> the yml under the checkout's cfgs/ it stands for
CFGS = {name: osp.join(ROOT_DIR, "cfgs", path) for name, path in (
    ("ssd_vgg16_voc", "base/ssd_vgg16_voc.yml"),
    ("ssd_vgg16_coco", "base/ssd_vgg16_coco.yml"),
    ("ssd_vgg16_coco_image512", "base/ssd_vgg16_coco_image512.yml"),
    ("ssd_vgg16_voc_image512", "vgg/ssd_vgg16_voc_image512.yml"),
    ("fpn_vgg16_voc", "vgg/fpn_vgg16_voc.yml"),
    ("fssd_vgg16_voc", "fssd/fssd_vgg16_voc.yml"),
    ("rfbnet300_vgg16_voc", "rfb/rfbnet300_vgg16_voc.yml"),
    ("rfbnet512_vgg16_voc", "rfb/rfbnet512_vgg16_voc.yml"),
    ("ssd_drn22_voc", "drn/ssd_drn22_voc.yml"),
    ("ssd_drn24_voc", "drn/ssd_drn24_voc.yml"),
    ("refinedet320_vgg16_voc", "refinedet/refinedet320_vgg16_voc.yml"))}
# no yml: odtpu builds DRN_SSD only from code (tests/test_model_zoo.py)
CFGS["drnssd_drn22_voc"] = None
_CODE_ONLY = {"drnssd_drn22_voc": {"MODEL": {"SSD_TYPE": "DRN_SSD",
                                             "BASE": "drn_d_22"}}}


def merge_cfg_from_file(cfg_filename: str, dst: AttrDict) -> AttrDict:
    """Read the yml ``cfg_filename`` (``utils.yml``) and merge it into
    ``dst`` strictly, then fill the derived values."""
    tree = yml.load(cfg_filename)
    if tree is None:
        tree = {}
    if not isinstance(tree, dict):
        raise ValueError("{}: the top of a config yml is a mapping, got "
                         "{}".format(cfg_filename, type(tree).__name__))
    _merge_a_into_b(AttrDict(tree), dst)
    return update_cfg(dst)


def _merge_a_into_b(a: AttrDict, b: AttrDict, stack=None) -> None:
    """Merge ``a`` into ``b``; an unknown key is an error."""
    for k, v_ in a.items():
        full_key = ".".join(stack) + "." + k if stack is not None else k
        if k not in b:
            raise KeyError("Non-existent config key: {}".format(full_key))
        v = _decode_cfg_value(copy.deepcopy(v_))
        v = _coerce_cfg_value_type(v, b[k], full_key)
        if isinstance(v, AttrDict):
            _merge_a_into_b(v, b[k], [k] if stack is None else stack + [k])
        else:
            b[k] = v


def _decode_cfg_value(v):
    """A yml value as the tree holds it: a mapping as an AttrDict, a
    string through ``literal_eval`` where it is a Python literal
    (``(('2007', 'test'),)``, ``1e-3``)."""
    if isinstance(v, dict):
        return AttrDict(v)
    if not isinstance(v, str):
        return v
    try:
        v = literal_eval(v)
    except (ValueError, SyntaxError):
        pass  # a plain string
    return v


def _coerce_cfg_value_type(value_a, value_b, full_key):
    """``value_a`` (from the yml) in the type of the default ``value_b``
    where the two may stand for each other, else a ValueError."""
    type_a, type_b = type(value_a), type(value_b)
    if type_a is type_b:
        return value_a
    if value_b is None:
        return value_a
    if isinstance(value_b, np.ndarray):
        return np.array(value_a, dtype=value_b.dtype)
    if isinstance(value_b, str):
        return str(value_a)
    if isinstance(value_a, tuple) and isinstance(value_b, list):
        return list(value_a)
    if isinstance(value_a, list) and isinstance(value_b, tuple):
        return tuple(value_a)
    if isinstance(value_a, int) and isinstance(value_b, float):
        return float(value_a)
    raise ValueError(
        "Type mismatch ({} vs. {}) with values ({} vs. {}) for config key: "
        "{}".format(type_b, type_a, value_b, value_a, full_key))


def _overlay(overlay: dict, into: AttrDict) -> None:
    for key, value in overlay.items():
        if isinstance(value, dict):
            _overlay(value, into[key])
        else:
            into[key] = copy.deepcopy(value)


def load_cfg(name: str = "ssd_vgg16_voc") -> AttrDict:
    """A fresh config tree (derived values filled in): the defaults with
    a yml laid over them. ``name`` is one of :data:`CFGS` or the path of
    any yml (``odtpu``'s ``load_cfg(path)``)."""
    c = _defaults()
    if name in CFGS:
        if CFGS[name] is None:
            _overlay(_CODE_ONLY[name], c)
            return update_cfg(c)
        return merge_cfg_from_file(CFGS[name], c)
    if not (name.endswith((".yml", ".yaml")) or osp.sep in name):
        raise KeyError("unknown config {!r}; known: {} or a yml's path"
                       .format(name, sorted(CFGS)))
    return merge_cfg_from_file(name, c)


def _yml_path(path: str) -> str:
    """``path`` as given (from the working directory) or, failing that,
    from the checkout's root; its absolute form."""
    for candidate in (path, osp.join(ROOT_DIR, path)):
        if osp.isfile(candidate):
            return osp.abspath(candidate)
    raise SystemExit("--cfg {}: no such file".format(path))


def resolve_cfg_args(args) -> AttrDict:
    """The config tree the command lines' ``args`` ask for, from
    :func:`load_cfg`; fills ``args.cfg_name`` and ``args.job_group``, the
    run's name, as ``odtpu.utils.config.resolve_cfg_args`` does.

    ``--cfg`` is the path of any yml (from the working directory, or
    from the checkout's root): the run is named ``<stem>`` in group
    ``<parent>`` (``base`` when the parent is ``cfgs``) unless
    ``--cfg_name``/``--job_group`` are given. It is read as the name of
    :data:`CFGS` where it is the checkout's own file of that name, else
    from its absolute path. Without ``--cfg``, ``--cfg_name`` (default
    ssd_vgg16_voc) names an entry of :data:`CFGS`, or else the yml
    ``cfgs/<job_group>/<cfg_name>.yml`` of the checkout, as ``odtpu``
    builds that path; ``--job_group`` defaults to base.
    """
    if getattr(args, "cfg", ""):
        path = _yml_path(args.cfg)
        if not getattr(args, "cfg_name", ""):
            args.cfg_name = osp.splitext(osp.basename(path))[0]
        if not getattr(args, "job_group", ""):
            parent = osp.basename(osp.dirname(path))
            args.job_group = parent if parent and parent != "cfgs" \
                else "base"
        names = [n for n, p in CFGS.items()
                 if p and osp.isfile(p) and osp.samefile(p, path)]
        name = names[0] if names else path
    else:
        args.cfg_name = getattr(args, "cfg_name", "") or "ssd_vgg16_voc"
        args.job_group = getattr(args, "job_group", "") or "base"
        name = args.cfg_name
        if name not in CFGS:
            path = osp.join(ROOT_DIR, "cfgs", args.job_group,
                            name + ".yml")
            if not osp.isfile(path):
                raise SystemExit(
                    "--cfg_name {}: not one of {}, and no {}".format(
                        name, ", ".join(sorted(CFGS)), path))
            name = path
    try:
        cfg = load_cfg(name)
    except (KeyError, ValueError) as e:
        raise SystemExit("{}: {}".format(name, e.args[0])) from None
    flat = [s for k in ("TRAIN_SETS", "TEST_SETS")
            for s in cfg.DATASET[k] if isinstance(s, str)]
    if flat:
        raise SystemExit(
            "{}: its yml names data sets as {}, where the datasets take "
            "(year, set) pairs; odtpu reads that yml the same way".format(
                name, flat))
    return cfg
