"""The demos: one image (``detect_img``) and a stream of frames (``live``)
through the serving path (``infer.Detector``), with what they share: the
configuration and weights a command line names, the detections of one
frame in its own pixels, and the boxes drawn on it."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.augment import resize_u8
from ..data.voc import VOC_CLASSES
from ..infer import Detector, random_state_dict
from ..utils.checkpoint import read_weights
from ..utils.config import load_cfg, resolve_cfg_args
from ..utils.visualize import put_text, rectangle


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cfg", default="ssd_vgg16_voc",
                   help="one of utils.config.CFGS, or the path of any "
                        "yml")
    p.add_argument("--ckpt", default="",
                   help="a checkpoint dir of the train command line (its "
                        "latest step) or an odtpu npz")
    p.add_argument("--npz", default="", help="an odtpu npz")
    p.add_argument("--seed", type=int, default=0,
                   help="seeded weights (infer.random_state_dict) when "
                        "neither --ckpt nor --npz is given")
    p.add_argument("--device", default="cuda")


def detector(args) -> Detector:
    """The detector ``args`` (:func:`add_model_args`) name."""
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    if args.cfg.endswith((".yml", ".yaml")):
        cfg = resolve_cfg_args(argparse.Namespace(cfg=args.cfg, cfg_name="",
                                                  job_group=""))
    else:
        cfg = load_cfg(args.cfg)
    if args.npz or args.ckpt:
        state_dict = read_weights(args.npz or args.ckpt)
    else:
        print("no --ckpt or --npz: seeded weights (seed {})".format(
            args.seed))
        state_dict = random_state_dict(cfg, args.seed)
    return Detector(cfg, state_dict=state_dict, device=args.device)


def class_names(cfg):
    """VOC's names for a 20-class dataset (``names[cls - 1]``), else None
    (the class number is printed)."""
    return list(VOC_CLASSES) if cfg.DATASET.NUM_CLASSES == 20 else None


def detect(det: Detector, frame: np.ndarray) -> np.ndarray:
    """The rows [R, 6] (score, x1, y1, x2, y2, cls; boxes in [0, 1]) of a
    uint8 BGR frame, resized to the network input on the host."""
    x = resize_u8(np.ascontiguousarray(frame), det.cfg.MODEL.IMAGE_SIZE)
    return det(x[None])["rows"][0].cpu().numpy()


def label_of(cls, names) -> str:
    return names[int(cls) - 1] if names else str(int(cls))


def draw(frame: np.ndarray, rows: np.ndarray, conf: float, names,
         clip: bool = True) -> int:
    """Draw the rows scoring at least ``conf`` on ``frame`` in place, as
    ``demo/detect_img.py:66-76`` does (green, thickness 2, the label and
    score above the box's corner; ``clip=False``: the corners unclipped,
    as ``demo/live.py`` draws); returns how many."""
    h, w = frame.shape[:2]
    kept = 0
    for score, x1, y1, x2, y2, cls in rows:
        if score < conf:
            continue
        kept += 1
        if clip:
            pt1 = (int(np.clip(x1 * w, 0, w - 1)),
                   int(np.clip(y1 * h, 0, h - 1)))
            pt2 = (int(np.clip(x2 * w, 0, w - 1)),
                   int(np.clip(y2 * h, 0, h - 1)))
        else:
            pt1, pt2 = (int(x1 * w), int(y1 * h)), (int(x2 * w), int(y2 * h))
        rectangle(frame, pt1, pt2, (0, 255, 0), 2)
        org = (pt1[0], max(pt1[1] - 4, 10) if clip else pt1[1] - 4)
        put_text(frame, "{} {:.2f}".format(label_of(cls, names), score),
                 org, (0, 255, 0))
    return kept
