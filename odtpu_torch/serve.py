"""A detection server over HTTP: the port's counterpart of ``tools/serve.py``.

POST an image's raw bytes (binary PPM; JPEG or PNG where OpenCV is
installed) to ``/detect`` and get::

    {"detections": [{"class": str, "class_id": int, "score": float,
                     "box": [x1, y1, x2, y2]}, ...],   # pixels
     "latency_ms": float}

``GET /healthz`` gives ``{"ok": true}``; any other path 404, a bad
length or bytes that do not decode 400. Each request is one batch-1 call
of ``infer.Detector`` (the eval step, the CUDA NMS kernel on a card), in
the configuration's compute dtype or with ``--quant int8`` in int8 convs.
Single-threaded, as the original is: one request at a time on the card.

    python -m odtpu_torch.serve [--port 8500] [--cfg ssd_vgg16_voc]
        [--ckpt DIR | --ckpt PATH.npz | --npz PATH.npz] [--conf 0.5]
        [--quant int8] [--device cuda]

``--cfg`` is a name of ``utils.config.CFGS`` or the path of any yml;
``--ckpt`` a checkpoint directory of ``python -m odtpu_torch.train`` (its
latest step) or an ``odtpu`` npz, as ``tools/serve.py`` takes it;
without ``--ckpt`` or ``--npz`` the server answers with the seeded
weights of ``infer.random_state_dict``. ``--port 0`` takes a free port;
the line printed at start names it.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import numpy as np
import torch

from .data.augment import resize_u8
from .data.image import imdecode
from .data.voc import VOC_CLASSES
from .infer import Detector, random_state_dict
from .utils.checkpoint import read_weights
from .utils.config import CFGS, load_cfg, refuse_mesh, resolve_cfg_args

MAX_BYTES = 32 * 1024 * 1024


def build_engine(cfg, npz: str = "", quant: str = "", device="cuda",
                 seed: int = 0, ckpt: str = ""):
    """-> (infer(img_bgr_u8 [H, W, 3], conf_thresh=0.5) -> list of
    detections, class names), as ``tools/serve.py``'s ``build_engine``:
    the image resized to the network's size (``resize_u8``, cv2's
    INTER_LINEAR bit for bit), one batch-1 detector call, the rows at or
    over ``conf_thresh`` named, their scores rounded to 4 places and
    their boxes scaled to the image's pixels and rounded to 1
    (:func:`detections`). The weights are those of ``ckpt`` or ``npz``
    (``utils.checkpoint.read_weights``), else seeded. Off the card it
    computes in float32, as the original does off the TPU.
    ``quant`` ("int8"), where given, overrides ``cfg.TPU.QUANT``; both
    changes go to a copy of ``cfg``. It warms up once before it
    returns."""
    refuse_mesh(cfg, "python -m odtpu_torch.serve")
    if npz and ckpt:
        raise ValueError("give --ckpt or --npz, not both")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    cfg = copy.deepcopy(cfg)
    if quant:
        cfg.TPU.QUANT = quant
    if device.type != "cuda":
        cfg.TPU.COMPUTE_DTYPE = "float32"
    state_dict = (read_weights(npz or ckpt) if npz or ckpt
                  else random_state_dict(cfg, seed=seed))
    detector = Detector(cfg, state_dict=state_dict, device=device)
    ih, iw = cfg.MODEL.IMAGE_SIZE
    n = cfg.DATASET.NUM_CLASSES
    names = list(VOC_CLASSES) if n == 20 else [str(i) for i in range(n)]

    def infer(img_bgr_u8, conf_thresh=0.5):
        x = resize_u8(img_bgr_u8, (ih, iw))[None]
        return detections(detector(x)["rows"][0].cpu().numpy(),
                          img_bgr_u8.shape[:2], names, conf_thresh)

    infer(np.zeros((ih, iw, 3), np.uint8), conf_thresh=1.1)
    return infer, names


def detections(rows, hw, names, conf_thresh=0.5) -> list:
    """A detector's rows [R, 6] (score, x1, y1, x2, y2, cls; boxes in
    [0, 1]) of an image of ``hw`` = (height, width) pixels -> the rows at
    or over ``conf_thresh``, named, their scores rounded to 4 places and
    their boxes in pixels rounded to 1, as ``tools/serve.py`` answers."""
    h, w = hw
    out = []
    for score, x1, y1, x2, y2, cls in rows:
        if score < conf_thresh:
            continue
        out.append({
            "class": names[int(cls) - 1],
            "class_id": int(cls) - 1,
            "score": round(float(score), 4),
            "box": [round(float(x1 * w), 1), round(float(y1 * h), 1),
                    round(float(x2 * w), 1), round(float(y2 * h), 1)],
        })
    return out


def make_server(infer, host: str = "0.0.0.0", port: int = 8500,
                conf: float = 0.5) -> HTTPServer:
    """An ``HTTPServer`` on (host, port) answering with ``infer`` (from
    :func:`build_engine`) at threshold ``conf``; port 0 takes a free one
    (``server.server_address`` names it). The caller runs
    ``serve_forever`` and, to stop, ``shutdown`` and ``server_close``."""

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                return self._json(200, {"ok": True})
            return self._json(404, {"error": "use POST /detect"})

        def do_POST(self):
            if not self.path.startswith("/detect"):
                return self._json(404, {"error": "use POST /detect"})
            n = int(self.headers.get("Content-Length", 0))
            if n == 0 or n > MAX_BYTES:
                return self._json(400, {"error": "bad content length"})
            data = self.rfile.read(n)
            try:
                img = imdecode(data, "the request body")
            except ImportError as e:
                return self._json(400, {"error": str(e)})
            if img is None:
                return self._json(400, {"error": "undecodable image"})
            t0 = time.perf_counter()
            dets = infer(img, conf)
            return self._json(200, {
                "detections": dets,
                "latency_ms": round((time.perf_counter() - t0) * 1000, 2)})

        def log_message(self, fmt, *a):  # quiet
            pass

    return HTTPServer((host, port), Handler)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port", type=int, default=8500,
                   help="0 takes a free port")
    p.add_argument("--cfg", default="ssd_vgg16_voc",
                   help="a name of utils.config.CFGS, or the path of any "
                   "yml")
    p.add_argument("--ckpt", default="",
                   help="a checkpoint dir of python -m odtpu_torch.train "
                   "(its latest step) or an odtpu npz; default: "
                   "infer.random_state_dict(0)")
    p.add_argument("--npz", default="",
                   help="an odtpu npz of that configuration")
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="quantized serving compute (overrides TPU.QUANT)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cfg(args.cfg) if args.cfg in CFGS else resolve_cfg_args(
        SimpleNamespace(cfg=args.cfg, cfg_name="", job_group=""))
    infer, _ = build_engine(cfg, args.npz, args.quant, args.device,
                            ckpt=args.ckpt)
    server = make_server(infer, port=args.port, conf=args.conf)
    print("serving {} on :{} (POST /detect, GET /healthz)".format(
        args.cfg, server.server_address[1]), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
