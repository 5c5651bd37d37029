"""The data path: image decoding, the host augmentation and its C++
sampler, VOC and COCO, the loader, the on-device photometric
augmentation, and :func:`dataset_factory`."""

from __future__ import annotations

from .. import parallel
from .augment import SSDAugmentation
from .coco import COCODetection
from .loader import DetLoader
from .voc import VOCDetection


def dataset_factory(phase, cfg):
    """A loader of ``cfg``'s dataset (``odtpu/data/__init__.py``): phase
    "train" shuffles, drops the last short batch and augments fully;
    "eval" keeps the order and resizes, the uint8 images normalised on
    the device. On a mesh each data index loads its slice
    (``DetLoader(shard=(d, D))``: every model and spatial rank of it the
    same images), and the train batch is its share of
    ``TRAIN_BATCH_SIZE``, the global batch; the eval batch stays whole on
    each data index, as in odtpu, and the evaluator gathers the rows."""
    name = cfg.DATASET.NAME.upper()
    train = phase == "train"
    sets = cfg.DATASET.TRAIN_SETS if train else cfg.DATASET.TEST_SETS
    image_cache = None
    if bool(cfg.DATASET.CACHE_IMAGES):
        # one budget per dataset root, shared by the run's two loaders
        from .cache import shared_cache
        image_cache = shared_cache(cfg.DATASET.DATASET_DIR,
                                   float(cfg.DATASET.CACHE_GB))
    if name.startswith("VOC"):
        dataset = VOCDetection(cfg.DATASET.DATASET_DIR, sets,
                               image_cache=image_cache)
    elif name.startswith("COCO"):
        dataset = COCODetection(cfg.DATASET.DATASET_DIR, sets,
                                image_cache=image_cache)
    else:
        raise KeyError("unknown dataset {!r}".format(cfg.DATASET.NAME))
    transform = SSDAugmentation(
        cfg.DATASET.IMAGE_SIZE, cfg.DATASET.PIXEL_MEANS,
        use_base=not train,
        device_photometric=train and bool(cfg.DATASET.DEVICE_PHOTOMETRIC),
        device_normalize=not train,
        photometric=bool(cfg.DATASET.PHOTOMETRIC))
    world, rank = parallel.data_world(), parallel.data_rank()
    batch = int(cfg.DATASET.TRAIN_BATCH_SIZE if train
                else cfg.DATASET.EVAL_BATCH_SIZE)
    if train and world > 1:
        if batch % world:
            raise ValueError("TRAIN_BATCH_SIZE {} does not divide among {} "
                             "data indices".format(batch, world))
        batch //= world
    return DetLoader(
        dataset, transform, batch_size=batch,
        max_boxes=int(cfg.DATASET.MAX_BOXES),
        shuffle=train, drop_last=train,
        num_workers=int(cfg.DATASET.NUM_WORKERS),
        num_pics=0 if train else int(cfg.DATASET.NUM_EVAL_PICS),
        shard=(rank, world))
