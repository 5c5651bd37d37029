"""Batched detection: the port's serving entry point, for every family.

Counterpart of ``bench.py``'s ``infer_fn`` (lines 373-381): uint8 BGR
NHWC batches in, ``[B, R, 6]`` rows (score, x1, y1, x2, y2, cls) and
the ``dropped`` count out, for any configuration (a name of
``utils.config.CFGS`` or the path of a yml):

    python -m odtpu_torch.infer --cfg rfbnet300_vgg16_voc --batch 32 \
        --batches 20 --seed 0 [--npz PATH] [--quant int8] [--device cpu]

prints one JSON line: images/s, ms per batch, the serving mode
(``--quant``: "" for the compute dtype, "int8" for dynamic int8 convs),
the peak device memory and the device (on CUDA also the card's power
limit, which its clocks under load depend on).
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time

import numpy as np
import torch

from . import parallel
from .eval_step import make_eval_step
from .models import model_factory, shard_model
from .models.common import Conv
from .utils.checkpoint import load_odtpu_npz, load_strict
from .utils.config import default_cfg, load_cfg, refuse_mesh


# the first conv of :func:`random_state_dict`, the one that sees the raw
# pixels, is divided by this, by base. The input arrives at raw pixel
# scale (mean-subtracted uint8, std ~70), and at odtpu's init the random
# loc head of SSD300 reaches |loc| ~ 1000 at full width, where
# exp(0.2 * loc) in decode overflows float32 and the boxes turn inf/NaN.
# With zero biases and batch norm at its init (running mean 0, variance
# 1: it normalises nothing) the heads are linear in this scale, except
# after an L2Norm. The DRN bases add a residual at each of their 8
# blocks, which grows the loc head further, so they take 8 times more
# (chip_smoke.py's families phase prints the largest |loc| served)
RANDOM_INPUT_SCALE = {"vgg16": 64.0, "drn_d_22": 512.0, "drn_d_24": 512.0}


def random_state_dict(cfg=None, seed: int = 0) -> dict:
    """Seeded random weights of ``cfg``'s detector (default SSD300) that
    serve finite boxes: the model's init
    (:func:`odtpu_torch.models.init_weights`) with the base's first conv
    divided by its :data:`RANDOM_INPUT_SCALE`. On the CPU."""
    cfg = default_cfg() if cfg is None else cfg
    model, _, _ = model_factory("eval", cfg, "cpu", seed)
    first = next(m for m in model.backbone.modules() if isinstance(m, Conv))
    with torch.no_grad():
        first.conv.weight /= RANDOM_INPUT_SCALE[cfg.MODEL.BASE]
    return model.state_dict()


class Detector:
    """A detector of ``cfg``'s family (default SSD300-VGG16) on one device.

    Weights come from ``state_dict`` as given (see
    :func:`odtpu_torch.utils.checkpoint.from_odtpu_params` and
    :func:`random_state_dict`), else from the model's seeded init, whole:
    on a mesh each rank then keeps its part (``models.shard_model``);
    outside a process group a ``cfg`` that asks for a mesh is refused.
    ``detector(images)`` takes uint8 BGR [B, H, W, 3] (numpy or tensor)
    and returns ``{"rows", "dropped"}`` on the device, as ``odtpu``'s
    serving tools return the compact rows whatever ``EVAL.COMPACT`` says;
    ``compact=None`` follows ``EVAL.COMPACT`` (the evaluators' dense
    contract, for the eval command line). ``quant`` ("" or "int8")
    overrides ``cfg.TPU.QUANT`` on a copy of ``cfg``; None serves as
    ``cfg`` says.
    """

    def __init__(self, cfg=None, state_dict=None, device="cuda", seed=0,
                 quant=None, compact=True):
        self.cfg = default_cfg() if cfg is None else cfg
        if quant is not None:
            self.cfg = copy.deepcopy(self.cfg)
            self.cfg.TPU.QUANT = quant
        if not parallel.initialized():
            refuse_mesh(self.cfg, "odtpu_torch.infer's Detector (infer, "
                        "serve, export and the demos)")
        self.device = torch.device(device)
        model, priors, _ = model_factory("eval", self.cfg, self.device, seed)
        if state_dict is not None:
            load_strict(model, state_dict)
        # on a mesh (the eval command line's --multihost): this rank's part
        shard_model(model, self.cfg)
        model.eval()
        if self.device.type == "cuda":
            # NHWC in memory: the NHWC->NCHW permute of the input is then
            # free and cuDNN runs its channels-last conv kernels
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.step = make_eval_step(model, priors, self.cfg, compact)

    def __call__(self, images) -> dict:
        return self.step(images)


def power_limit() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip()


def random_images(batch: int, size, seed: int) -> np.ndarray:
    """Seeded uint8 BGR NHWC images."""
    h, w = size
    return np.random.RandomState(seed).randint(
        0, 256, (batch, h, w, 3), dtype=np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg", default="ssd_vgg16_voc",
                    help="a name of utils.config.CFGS, or the path of any "
                    "yml")
    ap.add_argument("--npz", default="",
                    help="odtpu checkpoint of that configuration; default: "
                    "random_state_dict(seed)")
    ap.add_argument("--quant", default="", choices=["", "int8"],
                    help="serving compute: the compute dtype, or int8 "
                    "convs (heads in the compute dtype)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    cfg = load_cfg(args.cfg)
    cfg.TPU.QUANT = args.quant
    state_dict = (load_odtpu_npz(args.npz) if args.npz
                  else random_state_dict(cfg, seed=args.seed))
    det = Detector(cfg, state_dict=state_dict, device=device)
    images = torch.from_numpy(random_images(
        args.batch, det.cfg.MODEL.IMAGE_SIZE, args.seed)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(2):  # warm-up: cuDNN plans, the kernel build
        det(images)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.batches):
        out = det(images)
    sync()
    seconds = time.perf_counter() - t0
    result = {
        "images_per_s": args.batch * args.batches / seconds,
        "ms_per_batch": 1e3 * seconds / args.batches,
        "cfg": args.cfg, "batch": args.batch, "batches": args.batches,
        "dtype": det.cfg.TPU.COMPUTE_DTYPE, "quant": args.quant,
        "rows_shape": list(out["rows"].shape),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if device.type == "cuda":
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
        result["power_limit"] = power_limit()
    else:
        result["max_memory_allocated"] = None  # not tracked on the CPU
    print(json.dumps(result))


if __name__ == "__main__":
    main()
