"""Batched SSD300-VGG16 inference: the port's serving entry point.

Counterpart of ``bench.py``'s ``infer_fn`` (lines 373-381): uint8 BGR
NHWC batches in, ``[B, 200, 6]`` rows (score, x1, y1, x2, y2, cls) and
the ``dropped`` count out.

    python -m odtpu_torch.infer --batch 32 --batches 20 --seed 0 \
        [--npz PATH] [--device cpu]

prints one JSON line: images/s, ms per batch and the device (on CUDA
also the card's power limit, which its clocks under load depend on).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .eval_step import make_eval_step
from .models import model_factory
from .utils.checkpoint import load_odtpu_npz
from .utils.config import default_cfg


# conv1_1 of :func:`random_state_dict` is divided by this: the input
# arrives at raw pixel scale (mean-subtracted uint8, std ~70), and at
# odtpu's init the random loc head reaches |loc| ~ 1000 at full width,
# where exp(0.2 * loc) in decode overflows float32 and the boxes turn
# inf/NaN
RANDOM_INPUT_SCALE = 64.0


def random_state_dict(cfg=None, seed: int = 0) -> dict:
    """Seeded random SSD300 weights that serve finite boxes: the model's
    init (:func:`odtpu_torch.models.init_weights`) with conv1_1 divided by
    :data:`RANDOM_INPUT_SCALE`. On the CPU."""
    cfg = default_cfg() if cfg is None else cfg
    model, _, _ = model_factory("eval", cfg, "cpu", seed)
    state = model.state_dict()
    state["backbone.conv1_1.conv.weight"] /= RANDOM_INPUT_SCALE
    return state


class Detector:
    """SSD300-VGG16 detector on one device.

    Weights come from ``state_dict`` as given (see
    :func:`odtpu_torch.utils.checkpoint.from_odtpu_params` and
    :func:`random_state_dict`), else from the model's seeded init.
    ``detector(images)`` takes uint8 BGR [B, H, W, 3] (numpy or tensor)
    and returns ``{"rows", "dropped"}`` on the device.
    """

    def __init__(self, cfg=None, state_dict=None, device="cuda", seed=0):
        self.cfg = default_cfg() if cfg is None else cfg
        self.device = torch.device(device)
        model, priors, _ = model_factory("eval", self.cfg, self.device, seed)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        model.eval()
        if self.device.type == "cuda":
            # NHWC in memory: the NHWC->NCHW permute of the input is then
            # free and cuDNN runs its channels-last conv kernels
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.step = make_eval_step(model, priors, self.cfg)

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
    ap.add_argument("--npz", default="",
                    help="odtpu SSD300 checkpoint; default: random_state_dict(seed)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    state_dict = (load_odtpu_npz(args.npz) if args.npz
                  else random_state_dict(seed=args.seed))
    det = Detector(state_dict=state_dict, device=device)
    images = torch.from_numpy(random_images(
        args.batch, det.cfg.MODEL.IMAGE_SIZE, args.seed)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(2):  # warm-up: cuDNN plans, the kernel build
        det(images)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.batches):
        out = det(images)
    sync()
    seconds = time.perf_counter() - t0
    result = {
        "images_per_s": args.batch * args.batches / seconds,
        "ms_per_batch": 1e3 * seconds / args.batches,
        "batch": args.batch, "batches": args.batches,
        "dtype": det.cfg.TPU.COMPUTE_DTYPE,
        "rows_shape": list(out["rows"].shape),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if device.type == "cuda":
        result["power_limit"] = power_limit()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
