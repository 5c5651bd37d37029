"""The host's fused sampler: ``csrc/sampler.cc``, built with g++ and
loaded with ``ctypes``.

Counterpart of ``odtpu/data/_native/__init__.py``. One pass over the
output composes the virtual expand canvas (the image pasted at (top,
left) on an infinite ``fill``-coloured canvas), takes a window of it,
flips it in x when asked and resizes it with cv2's uint8 INTER_LINEAR
fixed point, bit for bit (see the source's header). ``fused_sample_u8``
calls the C++ function; :func:`fused_sample_u8_plain` is the same
arithmetic in numpy, for the tests and ``chip_smoke.py``'s comparison.

The library goes to ``build/odtpu_torch/`` at the root of the checkout,
named after a hash of the source and the flags, and is built at the
first call, never on import. A failed build raises: there is no switch
that turns the sampler off and no silent fallback. The C++ function
holds no Python object, and ``ctypes`` releases the interpreter lock
around it, so loader threads run it side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops.cuda.build import BUILD_DIR, CSRC

SOURCE = CSRC / "sampler.cc"
# the taps' float arithmetic must round as numpy's does (the plain
# version): no -march=native and no contraction into multiply-adds
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

# calls of the C++ function (chip_smoke.py resets and reads it)
CALLS = 0

_lib = None
_lock = threading.Lock()


def library_path():
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / "sampler-{}.so".format(key[:16])


def build():
    """Compile ``csrc/sampler.cc`` unless its library is on disk; returns
    the library's path. Raises with g++'s output when the build fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".{}.tmp".format(os.getpid()))
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host sampler is built from "
                           "{} at first use".format(SOURCE)) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed ({}):\n{}\n{}".format(
            " ".join(cmd), proc.stdout, proc.stderr))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _function():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.odtpu_fused_sample_u8
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # src, h, w
                ctypes.c_int, ctypes.c_int,                    # top, left
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,                                  # flip
                ctypes.c_void_p,                               # fill[3]
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # out, oh, ow
            ]
            _lib = lib
    return _lib.odtpu_fused_sample_u8


def _check(src, rect, out_hw):
    if src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] != 3:
        raise ValueError("want uint8 [H, W, 3], got {} {}".format(
            src.dtype, src.shape))
    if src.shape[0] <= 0 or src.shape[1] <= 0:
        raise ValueError("empty image {}".format(src.shape))
    if rect[2] <= rect[0] or rect[3] <= rect[1] or min(out_hw) <= 0:
        raise ValueError("fused_sample_u8: degenerate window {} or output "
                         "{}".format(rect, out_hw))


def fused_sample_u8(src, top, left, rect, flip, fill, out_hw):
    """Sample the virtual canvas: ``src`` (uint8 BGR [H, W, 3]) pasted at
    (top, left) on an infinite ``fill``-coloured canvas; take the window
    ``rect`` = (x1, y1, x2, y2) in canvas coordinates, x-flip it when
    ``flip``, and resize it to ``out_hw`` = (out_h, out_w) as cv2's uint8
    INTER_LINEAR does. Returns a new uint8 [out_h, out_w, 3] array."""
    global CALLS
    rect = tuple(int(v) for v in rect)
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    _check(src, rect, (out_h, out_w))
    src = np.ascontiguousarray(src)
    fill = np.ascontiguousarray(np.asarray(fill, np.uint8).reshape(3))
    out = np.empty((out_h, out_w, 3), np.uint8)
    fn = _function()
    h, w, _ = src.shape
    rc = fn(src.ctypes.data, h, w, int(top), int(left), *rect,
            int(bool(flip)), fill.ctypes.data, out.ctypes.data, out_h, out_w)
    if rc != 0:
        raise ValueError("fused_sample_u8 refused window {} or output "
                         "{}".format(rect, out_hw))
    with _lock:
        CALLS += 1
    return out


def _taps(src: int, dst: int):
    """One axis's taps (t0, t1: indices into the window, clamped) and
    11-bit weights (a0, a1), as ``make_taps`` in sampler.cc computes
    them: the coordinate in double, rounded to float32, its floor, and
    the weights rounded half to even."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    one, unit = np.float32(1.0), np.float32(2048.0)
    a0 = np.rint((one - f) * unit).astype(np.int64)
    a1 = np.rint(f * unit).astype(np.int64)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1)


def fused_sample_u8_plain(src, top, left, rect, flip, fill, out_hw):
    """:func:`fused_sample_u8` in numpy: the same taps, the same integer
    horizontal pass and vertical combine, so the same bits."""
    x1, y1, x2, y2 = (int(v) for v in rect)
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    _check(src, (x1, y1, x2, y2), (out_h, out_w))
    h, w, _ = src.shape
    win_w, win_h = x2 - x1, y2 - y1
    fill = np.asarray(fill, np.uint8).reshape(3).astype(np.int64)
    xt0, xt1, xa0, xa1 = _taps(win_w, out_w)
    yt0, yt1, ya0, ya1 = _taps(win_h, out_h)

    def columns(t):  # window column -> image column, flipped if asked
        wx = win_w - 1 - t if flip else t
        return x1 + wx - int(left)

    rows = np.unique(np.concatenate([yt0, yt1]))  # window rows needed
    iy = y1 + rows - int(top)
    row_in = (iy >= 0) & (iy < h)
    img = src[np.clip(iy, 0, h - 1)].astype(np.int64)  # [R, W, 3]

    def taps_of(t):  # [R, out_w, 3] source pixels (or fill) of taps t
        ix = columns(t)
        inside = row_in[:, None] & ((ix >= 0) & (ix < w))[None, :]
        return np.where(inside[..., None], img[:, np.clip(ix, 0, w - 1)],
                        fill)

    acc = xa0[None, :, None] * taps_of(xt0) + xa1[None, :, None] * taps_of(
        xt1)
    where = np.searchsorted(rows, np.arange(win_h))  # window row -> acc row
    r0, r1 = acc[where[yt0]], acc[where[yt1]]
    b0, b1 = ya0[:, None, None], ya1[:, None, None]
    out = (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)
