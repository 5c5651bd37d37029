"""Stream detection loop with an FPS counter: ``python -m
odtpu_torch.demo.live``.

Counterpart of ``demo/live.py``::

    python -m odtpu_torch.demo.live [--source 0] [--cfg ssd_vgg16_voc]
        [--ckpt DIR | --npz NPZ] [--conf 0.6] [--headless]
        [--max_frames N] [--device cuda]

``--source`` takes what ``cv2.VideoCapture`` takes. A printf pattern of
PPM frames (``frames/%04d.ppm``, which OpenCV also reads as an image
sequence: from the first index of 0-4 that exists, while the files go
on) is read here without OpenCV; a camera index or a video file needs
OpenCV, imported for it, and so does the window without
``--headless``. Each frame is detected through ``infer.Detector``;
headless, every detection scoring at least ``--conf`` is printed as
``frame <n> <label> <score> [x1,y1,x2,y2]``, else the frame is shown
with its boxes and FPS. The last line gives the frames and the FPS.
"""

from __future__ import annotations

import argparse
import os
import time

from ..data.image import imread
from ..utils.visualize import put_text
from . import add_model_args, class_names, detect, detector, draw, label_of


def _cv2(what):
    try:
        import cv2
    except ImportError as e:
        raise ImportError("{} needs OpenCV (cv2); without it, give a "
                          "pattern of PPM frames".format(what)) from e
    return cv2


def frames(source):
    """uint8 BGR frames of ``source``, one at a time."""
    if "%" in source:
        first = next((i for i in range(5) if os.path.isfile(source % i)),
                     None)
        if first is None:
            raise SystemExit("cannot open source {!r}".format(source))
        i = first
        while os.path.isfile(source % i):
            img = imread(source % i)
            if img is None:
                raise SystemExit("cannot read " + source % i)
            yield img
            i += 1
        return
    cv2 = _cv2("--source {!r}".format(source))
    cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
    if not cap.isOpened():
        raise SystemExit("cannot open source {!r}".format(source))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield frame
    finally:
        cap.release()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="odtpu_torch stream detection "
                                "demo")
    p.add_argument("--source", default="0",
                   help="cv2.VideoCapture source (index or path), or a "
                        "printf pattern of PPM frames")
    p.add_argument("--conf", type=float, default=0.6)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--max_frames", type=int, default=0)
    add_model_args(p)
    args = p.parse_args(argv)

    det = detector(args)
    names = class_names(det.cfg)
    cv2 = None if args.headless else _cv2("the display (without --headless)")
    n = 0
    first_rows = None
    t0 = time.time()
    for frame in frames(args.source):
        h, w = frame.shape[:2]
        rows = detect(det, frame)
        if first_rows is None:
            first_rows = rows
        n += 1
        fps = n / (time.time() - t0)
        if args.headless:
            for score, x1, y1, x2, y2, cls in rows:
                if score >= args.conf:
                    print("frame {} {} {:.2f} [{:.0f},{:.0f},{:.0f},{:.0f}]"
                          .format(n, label_of(cls, names), score, x1 * w,
                                  y1 * h, x2 * w, y2 * h))
        else:
            draw(frame, rows, args.conf, names, clip=False)
            put_text(frame, "FPS {:.1f}".format(fps), (8, 20), (0, 0, 255))
            cv2.imshow("odtpu live", frame)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        if args.max_frames and n >= args.max_frames:
            break
    fps = n / max(time.time() - t0, 1e-9)
    print("processed {} frames, {:.1f} fps".format(n, fps))
    return {"frames": n, "fps": fps, "first_rows": first_rows}


if __name__ == "__main__":
    main()
