"""Export the serving computation as one self-describing artifact.

Counterpart of ``tools/export_model.py``. The artifact holds the whole
serving computation, traced by ``torch.export``: a uint8 BGR NHWC batch
-> mean subtract -> BGR -> RGB -> the model in eval mode -> its
``decode`` (RefineDet's two-step decode) -> per-class NMS, one
``odtpu::nms_rows`` op (the CUDA kernel on a card, its plain twin on the
CPU) -> the cross-class ``[B, top_k, 6]`` rows (score, x1, y1, x2, y2,
cls). The priors and pixel means are constants of the graph, the
weights its state. It is one zip:

    * ``meta.json``    shapes, class names, the calling convention (the
                       keys of ``odtpu``'s, plus ``device``);
    * ``program.pt2``  the ``torch.export.save`` program.

Loading needs torch, numpy and the registration of the port's two ops
(``odtpu_torch.ops.cuda.nms_kernel``'s ``odtpu::nms_rows`` and
``odtpu_torch.ops.cuda.batch_norm``'s ``odtpu::bn_eval``, the
eval-mode batch norm of the batch-normed families): no model code and
no config. An
exported torch program is not StableHLO, so ``odtpu`` cannot read this
artifact, nor the port ``odtpu``'s.

    python -m odtpu_torch.export export --out ssd300.pt2.zip \\
        [--cfg_name NAME | --cfg cfgs/base/ssd_vgg16_voc.yml] \\
        [--ckpt CKPT_DIR | --ckpt model.npz] [--batch 1] [--quant int8] \\
        [--device cpu]          # --batch 0: any batch size

    python -m odtpu_torch.export run --artifact ssd300.pt2.zip \\
        --image img.ppm [--conf 0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import os.path as osp
import sys
import zipfile

import numpy as np
import torch
from torch import Tensor, nn

# registers odtpu::bn_eval and odtpu::nms_rows, the graph's own ops
from .ops.cuda import batch_norm, nms_kernel  # noqa: F401

FORMAT_VERSION = 1
PROGRAM = "program.pt2"


class ServingProgram(nn.Module):
    """uint8 BGR [B, H, W, 3] -> rows [B, top_k, 6]: the eval step's
    computation (``eval_step.EvalStep`` with ``R = EVAL.TOP_K``, as
    ``odtpu``'s export takes) as one module that ``torch.export`` traces.
    ``model`` is in eval mode and set to its serving mode."""

    def __init__(self, model: nn.Module, priors: Tensor, cfg):
        super().__init__()
        self.model = model
        self.priors = priors
        self.means = torch.tensor([float(m) for m in cfg.DATASET.PIXEL_MEANS],
                                  dtype=torch.float32, device=priors.device)
        self.variances = tuple(float(v) for v in cfg.MODEL.VARIANCE)
        self.conf_thresh = float(cfg.EVAL.CONF_THRESH)
        self.nms_thresh = float(cfg.EVAL.NMS_THRESH)
        self.top_k = int(cfg.EVAL.TOP_K)

    def forward(self, images: Tensor) -> Tensor:
        from .ops.detect import _compact, detect_decoded
        x = (images.float() - self.means).flip(-1)
        decoded, conf = self.model.decode(*self.model(x, phase="eval"),
                                          self.priors, self.variances)
        dense = detect_decoded(decoded, conf, self.conf_thresh,
                               self.nms_thresh, self.top_k,
                               row_compact=False)
        return _compact(dense, self.top_k)


def _state_dict(ckpt: str, model: nn.Module):
    """The weights ``ckpt`` names: a port checkpoint directory (its latest
    step) or an ``odtpu`` npz (with ``__batch_stats__/``); None for
    ``""``, the model's seeded init."""
    from .utils.checkpoint import Checkpointer, load_odtpu_npz
    if not ckpt:
        return None
    if osp.isdir(ckpt):
        return Checkpointer(ckpt).read()["model"]
    if not osp.isfile(ckpt):
        raise FileNotFoundError("checkpoint not found: " + ckpt)
    return load_odtpu_npz(ckpt, model)


def export_artifact(out_path, cfg=None, cfg_path: str = "", ckpt: str = "",
                    batch: int = 1, quant: str = "",
                    device="cuda") -> dict:
    """Trace the serving computation of ``cfg`` (default: the config of
    the yml ``cfg_path``, else SSD300-VGG16 VOC) with the weights of
    ``ckpt`` (default: the seeded init) on ``device`` and write the
    artifact to ``out_path``. ``batch=0`` exports a batch-polymorphic
    program; ``quant="int8"`` the int8 graph, its weights quantized in
    the graph from the float32 ones, as the live path quantizes them.
    Returns the meta dict."""
    from .models import model_factory
    from .models.common import set_quant
    from .data.voc import VOC_CLASSES
    from .utils.checkpoint import load_strict
    from .utils.config import load_cfg, resolve_cfg_args

    if cfg is None:
        if cfg_path and not osp.isfile(cfg_path):
            # an artifact built from the wrong config fails silently
            raise FileNotFoundError("config not found: " + cfg_path)
        cfg = load_cfg(resolve_cfg_args(argparse.Namespace(cfg=cfg_path)))
    cfg = copy.deepcopy(cfg)  # the mode never leaks into a caller's cfg
    if quant:
        cfg.TPU.QUANT = quant
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to export on "
                         "the CPU")
    model, priors, _ = model_factory("eval", cfg, device)
    state_dict = _state_dict(ckpt, model)
    if state_dict is not None:
        load_strict(model, state_dict)
    model.eval()
    set_quant(model, cfg.TPU.QUANT)
    if device.type == "cuda":
        # as the live Detector: NHWC weights, cuDNN's channels-last convs
        model = model.to(memory_format=torch.channels_last)
    program = ServingProgram(model, priors, cfg)

    ih, iw = (int(s) for s in cfg.MODEL.IMAGE_SIZE)
    example = torch.zeros((batch or 2, ih, iw, 3), dtype=torch.uint8,
                          device=device)
    dynamic = ({0: torch.export.Dim("b", min=1)},) if batch == 0 else None
    with torch.no_grad():
        exported = torch.export.export(program, (example,),
                                       dynamic_shapes=dynamic)
    n_cls = int(cfg.DATASET.NUM_CLASSES)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": "{}-{}".format(cfg.MODEL.SSD_TYPE, cfg.MODEL.BASE),
        "batch": int(batch),
        "image_size": [ih, iw],
        "input": "uint8 BGR [B,H,W,3] (cv2 imread order)",
        "output": "[B, {}, 6] rows (score,x1,y1,x2,y2,cls), desc score,"
                  " zero-padded; coords normalized".format(program.top_k),
        "num_weights": len(exported.state_dict),
        "quant": str(cfg.TPU.QUANT or ""),
        "dtype": str(cfg.TPU.COMPUTE_DTYPE),
        "platforms": ["cpu", "cuda"],
        "device": device.type,
        "class_names": (list(VOC_CLASSES) if n_cls == 20
                        else [str(i) for i in range(n_cls)]),
    }
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr(PROGRAM, buf.getvalue())
    return meta


def load_artifact(path, device="cuda"):
    """Load an artifact onto ``device``. Needs torch, numpy and the port's
    two registered ops only.

    Returns (call, meta): ``call(images)`` takes uint8 BGR [B, H, W, 3]
    (numpy or a tensor) of the exported shape (any B when exported with
    ``batch=0``) and returns the rows [B, top_k, 6] on ``device``."""
    device = torch.device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError("unsupported artifact version: {}".format(
                meta.get("format_version")))
        exported = torch.export.load(io.BytesIO(z.read(PROGRAM)))
    if meta["device"] != device.type:
        exported = torch.export.passes.move_to_device_pass(exported, device)
    module = exported.module().to(device)
    if device.type == "cuda":
        module = module.to(memory_format=torch.channels_last)
    want = tuple([meta["batch"] or "any"] + meta["image_size"] + [3])

    def call(images) -> Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        ok = (images.dtype == torch.uint8 and images.dim() == 4
              and tuple(images.shape[1:]) == want[1:]
              and (meta["batch"] == 0 or images.shape[0] == meta["batch"]))
        if not ok:
            raise ValueError("input {} {} != exported uint8 {}".format(
                images.dtype, tuple(images.shape), want))
        with torch.no_grad():
            return module(images.to(device, non_blocking=True))

    return call, meta


def run_image(call, meta, img: np.ndarray, conf: float = 0.5) -> list:
    """The detections of one uint8 BGR image through an artifact's
    ``call``, as ``tools/export_model.py``'s ``run`` prints them: the
    image resized to the network's size (``resize_u8``, cv2's
    INTER_LINEAR bit for bit), repeated to a fixed batch, the rows of
    score >= ``conf`` (and > 0, class >= 1) named, boxes in the image's
    pixels."""
    from .data.augment import resize_u8
    h, w = img.shape[:2]
    ih, iw = meta["image_size"]
    x = resize_u8(img, (ih, iw))[None]
    if meta["batch"] > 1:
        x = np.repeat(x, meta["batch"], axis=0)
    names = meta["class_names"]
    out = []
    for score, x1, y1, x2, y2, cls in call(x)[0].cpu().numpy():
        # class 0 rows are the fixed-shape output's zero padding
        if score <= 0 or int(cls) < 1 or score < conf:
            continue
        out.append({"class": names[int(cls) - 1],
                    "score": round(float(score), 4),
                    "box": [round(float(x1 * w), 1), round(float(y1 * h), 1),
                            round(float(x2 * w), 1),
                            round(float(y2 * h), 1)]})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("export")
    pe.add_argument("--out", required=True)
    pe.add_argument("--cfg_name", default="",
                    help="one of utils.config.CFGS (default ssd_vgg16_voc)")
    pe.add_argument("--cfg", default="",
                    help="a yml that utils.config.CFGS names")
    pe.add_argument("--ckpt", default="",
                    help="a port checkpoint dir or an odtpu npz; default: "
                         "the seeded init")
    pe.add_argument("--batch", type=int, default=1,
                    help="0: one program for any batch size")
    pe.add_argument("--quant", default="", choices=["", "int8"],
                    help="export the int8-quantized eval graph")
    pe.add_argument("--device", default="cuda")
    pr = sub.add_parser("run")
    pr.add_argument("--artifact", required=True)
    pr.add_argument("--image", required=True)
    pr.add_argument("--conf", type=float, default=0.5)
    pr.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.cmd == "export":
        from .utils.config import load_cfg, resolve_cfg_args
        cfg = load_cfg(resolve_cfg_args(args))
        meta = export_artifact(args.out, cfg, ckpt=args.ckpt,
                               batch=args.batch, quant=args.quant,
                               device=args.device)
        size_mb = osp.getsize(args.out) / 1e6
        print(json.dumps({"out": args.out, "size_mb": round(size_mb, 1),
                          **meta}, indent=1))
        return
    from .data.image import imread
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    call, meta = load_artifact(args.artifact, args.device)
    img = imread(args.image)
    if img is None:
        sys.exit("undecodable image: " + args.image)
    print(json.dumps({"detections": run_image(call, meta, img, args.conf)},
                     indent=1))


if __name__ == "__main__":
    main()
