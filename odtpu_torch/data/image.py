"""Images in and out: ``imread`` and ``imdecode`` (uint8 BGR HWC, as
``cv2.imread`` and ``cv2.imdecode``) and ``write_ppm``.

Counterpart of the ``cv2.imread`` calls of ``odtpu/data/voc.py:90``,
``coco.py:72`` and ``cache.py:49``, and of ``tools/serve.py``'s
``cv2.imdecode`` (lines 136-137). The format comes from the first bytes,
not from a file's name, as cv2 decides it. Binary PPM (``P6``, maxval
255) is decoded here with numpy, so a machine without OpenCV reads it;
any other format goes through ``cv2``, imported inside the call. Without
cv2, bytes of a known format (JPEG, PNG, ...) raise an ``ImportError``
that names it, and bytes of no known format give None. Like cv2, a file
that is missing, empty or cannot be decoded gives None.
"""

from __future__ import annotations

import numpy as np

# leading bytes -> format name, for the message when cv2 is missing
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG\r\n\x1a\n", "PNG"),
          (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
          (b"GIF8", "GIF"), (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"))
_PNM = {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P7"}
_WHITESPACE = b" \t\r\n\v\f"


def format_of(head: bytes) -> str:
    """The image format that a file's first bytes announce."""
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:2] in _PNM:
        return "PNM " + head[:2].decode()
    return "unknown format"


def _ppm_header(data: bytes):
    """(width, height, maxval, offset of the pixels) of a ``P6`` file, or
    None when its header is malformed. Header fields are separated by
    whitespace, a '#' comments to the end of its line, and one whitespace
    byte ends the header."""
    fields, pos, n = [], 2, len(data)
    while len(fields) < 3:
        while pos < n and data[pos] in _WHITESPACE:
            pos += 1
        if pos < n and data[pos] == ord("#"):
            while pos < n and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < n and data[pos] not in _WHITESPACE and data[pos] != ord(
                "#"):
            pos += 1
        token = data[start:pos]
        if not token.isdigit():
            return None
        fields.append(int(token))
    if pos >= n:
        return None
    width, height, maxval = fields
    return width, height, maxval, pos + 1


def _read_ppm(data: bytes):
    """A ``P6`` file with maxval 255 -> uint8 BGR [H, W, 3]; None when it
    is malformed or short; "cv2" for a maxval that needs cv2."""
    header = _ppm_header(data)
    if header is None:
        return None
    width, height, maxval, offset = header
    if maxval != 255:
        return "cv2"
    if width <= 0 or height <= 0 or len(data) - offset < width * height * 3:
        return None
    rgb = np.frombuffer(data, np.uint8, width * height * 3, offset)
    return np.ascontiguousarray(rgb.reshape(height, width, 3)[:, :, ::-1])


def imdecode(data: bytes, source: str = "the bytes"):
    """``cv2.imdecode(data, cv2.IMREAD_COLOR)``: uint8 BGR [H, W, 3], or
    None. ``source`` names the bytes in the error raised for a format
    that needs cv2 where there is none."""
    if data[:2] == b"P6":
        img = _read_ppm(data)
        if not isinstance(img, str):
            return img
    if not data:
        return None
    try:
        import cv2
    except ImportError as e:
        fmt = format_of(data[:16])
        if fmt == "unknown format":
            return None
        raise ImportError(
            "{}: a {} image, which needs OpenCV (cv2) to decode; "
            "without it only binary PPM (P6, maxval 255) is read".format(
                source, fmt)) from e
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def imread(path):
    """``cv2.imread(path)``: uint8 BGR [H, W, 3], or None."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imdecode(data, str(path))


def write_ppm(path, img: np.ndarray) -> None:
    """Write a uint8 BGR [H, W, 3] image as binary PPM (``P6``, maxval
    255), whatever the file's name."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("want uint8 [H, W, 3], got {} {}".format(
            img.dtype, img.shape))
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img[:, :, ::-1]).tobytes())
