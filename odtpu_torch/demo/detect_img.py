"""Single-image detection demo: ``python -m odtpu_torch.demo.detect_img``.

Counterpart of ``demo/detect_img.py``::

    python -m odtpu_torch.demo.detect_img --image img.ppm
        [--cfg ssd_vgg16_voc] [--ckpt DIR | --npz NPZ] [--out out.ppm]
        [--conf 0.5] [--device cuda]

reads the image (``data.image.imread``: PPM natively, other formats
through OpenCV), resizes it to the network input on the host, detects
through ``infer.Detector`` and draws the rows scoring at least
``--conf`` in the image's own pixels (green boxes, the VOC class name
and score above each). The result is written as PPM; another extension
of ``--out`` needs OpenCV, imported for the write.
"""

from __future__ import annotations

import argparse

from ..data.image import imread, write_ppm
from . import add_model_args, class_names, detect, detector, draw


def write_image(path, img) -> None:
    """``img`` to ``path``: PPM natively, any other format by cv2."""
    if str(path).lower().endswith((".ppm", ".pnm")):
        write_ppm(path, img)
        return
    try:
        import cv2
    except ImportError as e:
        raise ImportError("{}: writing this format needs OpenCV (cv2); "
                          "without it, write .ppm".format(path)) from e
    if not cv2.imwrite(str(path), img):
        raise OSError("cv2 could not write " + str(path))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="odtpu_torch single-image "
                                "detection demo")
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="detect_out.ppm")
    p.add_argument("--conf", type=float, default=0.5)
    add_model_args(p)
    args = p.parse_args(argv)

    img = imread(args.image)
    if img is None:
        raise SystemExit("cannot read " + args.image)
    det = detector(args)
    rows = detect(det, img)
    kept = draw(img, rows, args.conf, class_names(det.cfg))
    write_image(args.out, img)
    print("{} detections >= {:.2f} -> {}".format(kept, args.conf, args.out))
    return {"rows": rows, "kept": kept, "out": args.out}


if __name__ == "__main__":
    main()
