"""SSD train and eval image augmentation on the host, in numpy.

Counterpart of ``odtpu/data/augment.py`` (the reference's
``SSDAugmentation``, lib/utils/augmentations.py:407): the same ops in
the same order with the same probabilities, each drawing the same random
numbers from the caller's ``np.random.Generator`` in the same order:

  photometric distortion (float path) -> expand (mean fill, ratio 1-4,
  p = .5) -> min-IoU crop (6 modes, 50 trials, boxes kept whose centres
  fall inside) -> mirror -> to [0, 1] coordinates -> resize -> mean
  subtract (float path)

The eval transform (``use_base``) is the resize and the mean subtract.
``odtpu`` calls OpenCV where this module has its own numpy: ``bgr_to_hsv``
and ``hsv_to_bgr`` follow cv2's float formulas, ``resize_f32`` its float
INTER_LINEAR, and every uint8 resize goes through the host sampler
(``native.fused_sample_u8``, cv2's uint8 INTER_LINEAR bit for bit): the
device-photometric geometry composes, flips and resizes in one pass of
it, and the eval resize is its whole-image window with no flip.

Kept reference quirks, as in ``odtpu``: the crop's retry condition
``overlap.min() < min_iou and max_iou < overlap.max()`` (an AND,
augmentations.py:254), the crop rect from unrounded float sizes cut by
``int()``, and hue wrapping at 360 on full-range float HSV.

``SSDAugmentation.attach_writer`` arms ``odtpu``'s per-stage TensorBoard
dumps (``LOG.SHOW_AUG_STEPS``): the next ``max_dumps`` train items take
the stepwise path (expand, crop, mirror and resize one after the other,
the same draws) and log an image after each stage, their boxes in red.
"""

from __future__ import annotations

import threading

import numpy as np

from . import native

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def _iou_one_to_many(boxes: np.ndarray, rect: np.ndarray) -> np.ndarray:
    """IoU of [N, 4] boxes against one [4] rect (jaccard_numpy parity)."""
    ix1 = np.maximum(boxes[:, 0], rect[0])
    iy1 = np.maximum(boxes[:, 1], rect[1])
    ix2 = np.minimum(boxes[:, 2], rect[2])
    iy2 = np.minimum(boxes[:, 3], rect[3])
    iw = np.clip(ix2 - ix1, 0, None)
    ih = np.clip(iy2 - iy1, 0, None)
    inter = iw * ih
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (rect[2] - rect[0]) * (rect[3] - rect[1])
    return inter / (area_a + area_b - inter)


# --------------------------------------------------------------------------
# colour conversions and the float resize, as cv2 computes them
# --------------------------------------------------------------------------

def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on float32 [H, W, 3]: H in
    degrees [0, 360), S = (max - min) / (|max| + FLT_EPSILON), V = max. Any
    float input, [0, 255] or not, follows cv2's formula."""
    img = np.asarray(img, np.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    scale = np.float32(60.0) / (diff + _FLT_EPSILON)
    h = np.where(v == r, (g - b) * scale,
                 np.where(v == g, (b - r) * scale + np.float32(120.0),
                          (r - g) * scale + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32, copy=False)


# cv2's HSV2RGB sector table: which of (v, p, q, t) each of b, g, r takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` on float32 [H, W, 3] with H
    in degrees: H is brought into [0, 6) sectors by whole turns, and each
    channel is one of v, v(1 - s), v(1 - s f), v(1 - s(1 - f)); S = 0
    gives grey. Out-of-range S and V follow the same formula."""
    hsv = np.asarray(hsv, np.float32)
    h = hsv[..., 0] * np.float32(6.0 / 360.0)
    s, v = hsv[..., 1], hsv[..., 2]
    six = np.float32(6.0)
    while (h < 0).any():
        h = np.where(h < 0, h + six, h)
    while (h >= six).any():
        h = np.where(h >= six, h - six, h)
    sector = np.floor(h)
    f = h - sector
    sector = sector.astype(np.int64)
    bad = (sector < 0) | (sector >= 6)  # NaN hues: sector 0, f = 0
    sector = np.where(bad, 0, sector)
    f = np.where(bad, np.float32(0.0), f)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * f),
                    v * (one - s * (one - f))], axis=-1)
    out = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    grey = (s == 0)[..., None]
    return np.where(grey, v[..., None], out).astype(np.float32, copy=False)


def _linear_taps(src: int, dst: int, double: bool):
    """One axis of cv2's float INTER_LINEAR: for each output index the two
    source indices (clamped at the edges, as cv2 5.x replicates the edge)
    and their float32 weights (1 - f, f). The coordinate (d + 0.5) *
    src / dst - 0.5 is split into its floor and fraction in double when
    ``double``, else after a rounding to float32."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if not double:
        f = f.astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            np.float32(1.0) - f, f)


def resize_f32(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` on a
    float32 [H, W, C] image: the horizontal pass, then the vertical
    combine, each a two-tap float32 sum. ``size`` is (h, w). cv2 (5.0,
    probed tap by tap) splits the coordinates in double, except for an
    image one pixel high or wide, where it rounds them to float32 first."""
    out_h, out_w = int(size[0]), int(size[1])
    src_h, src_w = img.shape[:2]
    double = min(src_h, src_w) > 1
    x0, x1, ax0, ax1 = _linear_taps(src_w, out_w, double)
    y0, y1, by0, by1 = _linear_taps(src_h, out_h, double)
    rows = np.unique(np.concatenate([y0, y1]))  # the source rows read
    sub = np.asarray(img[rows], np.float32)
    hor = sub[:, x0] * ax0[None, :, None] + sub[:, x1] * ax1[None, :, None]
    where = np.searchsorted(rows, np.arange(src_h))
    out = (hor[where[y0]] * by0[:, None, None]
           + hor[where[y1]] * by1[:, None, None])
    return out.astype(np.float32, copy=False)


def resize_u8(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize`` (INTER_LINEAR) of a uint8 [H, W, 3] image to ``size``
    = (h, w), bit for bit: the sampler's whole-image window, no flip."""
    h, w = img.shape[:2]
    return native.fused_sample_u8(img, 0, 0, (0, 0, w, h), False, (0, 0, 0),
                                  size)


# --------------------------------------------------------------------------
# photometric ops (operate on float32 BGR HWC)
# --------------------------------------------------------------------------

def random_brightness(img, rng, delta=32.0):
    if rng.integers(2):
        img = img + rng.uniform(-delta, delta)
    return img


def random_contrast(img, rng, lower=0.5, upper=1.5):
    if rng.integers(2):
        img = img * rng.uniform(lower, upper)
    return img


def random_saturation(img_hsv, rng, lower=0.5, upper=1.5):
    if rng.integers(2):
        img_hsv[:, :, 1] *= rng.uniform(lower, upper)
    return img_hsv


def random_hue(img_hsv, rng, delta=18.0):
    if rng.integers(2):
        h = img_hsv[:, :, 0] + rng.uniform(-delta, delta)
        h = np.where(h > 360.0, h - 360.0, h)
        h = np.where(h < 0.0, h + 360.0, h)
        img_hsv[:, :, 0] = h
    return img_hsv


_CHANNEL_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                  (2, 1, 0))


def random_lighting_noise(img, rng):
    if rng.integers(2):
        perm = _CHANNEL_PERMS[rng.integers(len(_CHANNEL_PERMS))]
        img = img[:, :, perm]
    return img


def photometric_distort(img, rng):
    """Brightness, then contrast either before or after the HSV block,
    then channel shuffle (reference PhotometricDistort:357)."""
    img = random_brightness(img, rng)
    contrast_first = bool(rng.integers(2))
    if contrast_first:
        img = random_contrast(img, rng)
    hsv = bgr_to_hsv(img.astype(np.float32))
    hsv = random_saturation(hsv, rng)
    hsv = random_hue(hsv, rng)
    img = hsv_to_bgr(hsv)
    if not contrast_first:
        img = random_contrast(img, rng)
    return random_lighting_noise(img, rng)


# --------------------------------------------------------------------------
# geometric ops (absolute pixel coords)
# --------------------------------------------------------------------------

def _expand_fill(mean, dtype):
    """Expand-canvas fill value for an image dtype: a uint8 canvas rounds
    the mean (rather than truncating), so fractional PIXEL_MEANS still
    cancel against the on-device mean subtract to within 0.5 LSB."""
    return (np.rint(mean).astype(dtype)
            if np.issubdtype(dtype, np.integer) else mean)


def random_expand(img, boxes, rng, mean, max_ratio=4.0):
    if rng.integers(2):
        return img, boxes
    h, w, c = img.shape
    ratio = rng.uniform(1.0, max_ratio)
    left = int(rng.uniform(0.0, w * ratio - w))
    top = int(rng.uniform(0.0, h * ratio - h))
    canvas = np.empty((int(h * ratio), int(w * ratio), c), dtype=img.dtype)
    canvas[:, :, :] = _expand_fill(mean, img.dtype)
    canvas[top:top + h, left:left + w] = img
    boxes = boxes.copy()
    boxes[:, 0::2] += left
    boxes[:, 1::2] += top
    return canvas, boxes


# (min_iou, max_iou) sampling modes; None = whole image
_CROP_MODES = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None),
               (None, None))


def _crop_trial(boxes, labels, rng, width, height, min_iou, max_iou):
    """One trial of the min-IoU crop: None (rejected), or (rect, boxes
    inside it in its coordinates, their labels)."""
    w = rng.uniform(0.3 * width, width)
    h = rng.uniform(0.3 * height, height)
    if h / w < 0.5 or h / w > 2:
        return None
    left = rng.uniform(0, width - w)
    top = rng.uniform(0, height - h)
    rect = np.array([int(left), int(top), int(left + w), int(top + h)])
    overlap = _iou_one_to_many(boxes, rect)
    # reference quirk: AND, not OR (augmentations.py:254)
    if overlap.min() < min_iou and max_iou < overlap.max():
        return None
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
    inside = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1]) &
              (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
    if not inside.any():
        return None
    new_boxes = boxes[inside].copy()
    new_boxes[:, :2] = np.maximum(new_boxes[:, :2], rect[:2]) - rect[:2]
    new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:], rect[2:]) - rect[:2]
    return rect, new_boxes, labels[inside]


def _crop_bounds(rng):
    """Draw the crop mode: None for the whole image, else (min, max) IoU."""
    mode = _CROP_MODES[rng.integers(len(_CROP_MODES))]
    if mode is None:
        return None
    return (-np.inf if mode[0] is None else mode[0],
            np.inf if mode[1] is None else mode[1])


def random_sample_crop(img, boxes, labels, rng, trials=50):
    bounds = _crop_bounds(rng)
    if bounds is None or boxes is None or len(boxes) == 0:
        return img, boxes, labels
    height, width, _ = img.shape
    for _ in range(trials):
        got = _crop_trial(boxes, labels, rng, width, height, *bounds)
        if got is not None:
            rect, new_boxes, new_labels = got
            return (img[rect[1]:rect[3], rect[0]:rect[2], :], new_boxes,
                    new_labels)
    return img, boxes, labels


def _compose_crop(img, rect, top, left, fill):
    """Pixels of the virtual expanded canvas (img pasted at (top, left) on
    an infinite mean-coloured background) inside rect = (x1, y1, x2, y2),
    without materialising the canvas: only the strips of the window the
    pasted image does not cover are filled."""
    x1, y1, x2, y2 = rect
    h, w, c = img.shape
    out_h, out_w = y2 - y1, x2 - x1
    ix1, iy1 = max(x1, left), max(y1, top)
    ix2, iy2 = min(x2, left + w), min(y2, top + h)
    if ix1 >= ix2 or iy1 >= iy2:  # the window misses the image
        out = np.empty((out_h, out_w, c), img.dtype)
        out[:] = fill
        return out
    if (ix1, iy1, ix2, iy2) == (x1, y1, x2, y2):  # fully inside: a view
        return img[iy1 - top:iy2 - top, ix1 - left:ix2 - left]
    out = np.empty((out_h, out_w, c), img.dtype)
    oy1, oy2, ox1, ox2 = iy1 - y1, iy2 - y1, ix1 - x1, ix2 - x1
    if oy1 > 0:
        out[:oy1] = fill
    if oy2 < out_h:
        out[oy2:] = fill
    if ox1 > 0:
        out[oy1:oy2, :ox1] = fill
    if ox2 < out_w:
        out[oy1:oy2, ox2:] = fill
    out[oy1:oy2, ox1:ox2] = img[iy1 - top:iy2 - top, ix1 - left:ix2 - left]
    return out


def sample_expand_crop_geometry(shape_hw, boxes, labels, rng, max_ratio=4.0,
                                trials=50):
    """The random draws of random_expand then random_sample_crop, in the
    same order, for the geometry alone: no pixel is touched. Returns
    ``((top, left, rect), boxes, labels)``: the result image is the window
    ``rect`` = (x1, y1, x2, y2) of the virtual canvas (the input pasted at
    (top, left) on an infinite mean-coloured background), and ``boxes``
    are absolute coordinates in that window, never aliasing the input."""
    h, w = shape_hw
    if boxes is not None:
        boxes = boxes.copy()
    if rng.integers(2):
        top = left = 0
        eh, ew = h, w
    else:
        ratio = rng.uniform(1.0, max_ratio)
        left = int(rng.uniform(0.0, w * ratio - w))
        top = int(rng.uniform(0.0, h * ratio - h))
        eh, ew = int(h * ratio), int(w * ratio)
        boxes[:, 0::2] += left
        boxes[:, 1::2] += top
    bounds = _crop_bounds(rng)
    if bounds is None or boxes is None or len(boxes) == 0:
        return (top, left, (0, 0, ew, eh)), boxes, labels
    for _ in range(trials):
        got = _crop_trial(boxes, labels, rng, ew, eh, *bounds)
        if got is not None:
            rect, new_boxes, new_labels = got
            return ((top, left, tuple(int(v) for v in rect)), new_boxes,
                    new_labels)
    return (top, left, (0, 0, ew, eh)), boxes, labels


def random_expand_crop(img, boxes, labels, rng, mean, max_ratio=4.0,
                       trials=50):
    """Expand then crop with the canvas kept virtual: the draws of
    sample_expand_crop_geometry, then one compose of the chosen window.
    The same pixels as random_expand followed by random_sample_crop."""
    h, w, _ = img.shape
    geo, boxes, labels = sample_expand_crop_geometry(
        (h, w), boxes, labels, rng, max_ratio, trials)
    top, left, rect = geo
    fill = _expand_fill(mean, img.dtype)
    return _compose_crop(img, rect, top, left, fill), boxes, labels


def random_mirror(img, boxes, rng):
    if rng.integers(2):
        _, width, _ = img.shape
        img = img[:, ::-1]
        boxes = boxes.copy()
        # x1' = W - x2 ; x2' = W - x1  (reference slice trick, line 331)
        boxes[:, [0, 2]] = width - boxes[:, [2, 0]]
    return img, boxes


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------

class SSDAugmentation:
    """Callable (img_bgr_u8, boxes_norm, labels, rng) -> (image, boxes,
    labels). ``size`` is (h, w); ``mean`` is BGR.

    - ``use_base``: the eval transform (resize, then mean subtract unless
      ``device_normalize``, which keeps the resized uint8 BGR for the
      eval step to normalise on the device, exactly as the reference
      resizes uint8 before its float subtract);
    - ``device_photometric``: the host runs the geometry alone, in one
      sampler pass a uint8 image, and the train step distorts and
      normalises on the device (``data/device_aug.py``);
    - else the float path: distortion (unless ``photometric`` is False),
      geometry and resize in float32, mean subtracted.
    An item with no ground truth takes the eval resize.
    """

    def __init__(self, size=(300, 300), mean=(104, 117, 123),
                 use_base: bool = False, device_photometric: bool = False,
                 device_normalize: bool = False, photometric: bool = True):
        self.size = tuple(int(s) for s in size)
        self.mean = np.array(mean, dtype=np.float32)
        self.use_base = use_base
        self.photometric = photometric
        self.device_photometric = device_photometric
        self.device_normalize = device_normalize
        # step-by-step TB dumps (reference Compose tb_writer hook,
        # augmentations.py:395-404); attach_writer() arms them
        self.tb_writer = None
        self._max_dumps = 0
        self._dumps_done = 0
        self._dump_lock = threading.Lock()

    def attach_writer(self, tb_writer, max_dumps=8):
        """Arm per-stage augmentation image dumps (one TB image per
        pipeline stage for the next ``max_dumps`` items). Dump slots are
        claimed under a lock and TB writes are serialized, so the loader's
        threads dump at most ``max_dumps`` items, each under its own
        step."""
        self.tb_writer = tb_writer
        self._max_dumps = int(max_dumps)
        self._dumps_done = 0

    def _claim_dump_slot(self):
        """Atomically claim the next dump index, or None when spent."""
        if self.tb_writer is None:
            return None
        with self._dump_lock:
            if self._dumps_done >= self._max_dumps:
                return None
            idx = self._dumps_done
            self._dumps_done += 1
            return idx

    def _dump(self, stage, img, boxes, labels, step):
        from ..utils.visualize import vis_img_box
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        gt = None
        if boxes is not None and len(boxes):
            gt = np.concatenate(
                [np.asarray(boxes, np.float32).reshape(-1, 4),
                 np.asarray(labels, np.float32).reshape(-1, 1)], axis=1)
        with self._dump_lock:
            vis_img_box(u8, {"gt": gt} if gt is not None else {},
                        self.tb_writer, tag="augmentation/" + stage,
                        step=step)

    def _stepwise(self, img, boxes, labels, rng, slot):
        """``__call__``'s train transform one stage at a time, each stage's
        image dumped under step ``slot``: the same draws as the fused
        paths."""
        self._dump("0_input", img, boxes, labels, slot)
        if not self.device_photometric and self.photometric:
            img = photometric_distort(img, rng)
            self._dump("1_photometric", img, boxes, labels, slot)
        img, boxes = random_expand(img, boxes, rng, self.mean)
        self._dump("2_expand", img, boxes, labels, slot)
        img, boxes, labels = random_sample_crop(img, boxes, labels, rng)
        self._dump("3_crop", img, boxes, labels, slot)
        img, boxes = random_mirror(img, boxes, rng)
        self._dump("4_mirror", img, boxes, labels, slot)
        h, w, _ = img.shape
        boxes[:, 0::2] /= w  # to percent
        boxes[:, 1::2] /= h
        img = np.ascontiguousarray(img)
        img = (resize_u8(img, self.size) if img.dtype == np.uint8
               else resize_f32(img, self.size))
        self._dump("5_resize", img,
                   boxes * np.asarray([self.size[1], self.size[0]] * 2,
                                      np.float32), labels, slot)
        if self.device_photometric:
            return img, boxes, labels
        return img - self.mean, boxes, labels

    def base(self, img):
        img = (resize_u8(img, self.size) if img.dtype == np.uint8
               else resize_f32(img, self.size))
        if self.device_normalize or self.device_photometric:
            # uint8 BGR: the device normalises. device_photometric matters
            # here too: a train item with no ground truth takes this path
            # and must keep the batch's uint8 dtype
            return img
        return img.astype(np.float32) - self.mean

    def __call__(self, img, boxes=None, labels=None, rng=None):
        if self.use_base or boxes is None or len(boxes) == 0:
            return self.base(img), boxes, labels
        rng = np.random.default_rng() if rng is None else rng
        h, w, _ = img.shape
        boxes = boxes.astype(np.float32).copy()
        boxes[:, 0::2] *= w  # to absolute
        boxes[:, 1::2] *= h
        slot = self._claim_dump_slot()
        if slot is not None:
            if not self.device_photometric:
                img = img.astype(np.float32)
            return self._stepwise(img, boxes, labels, rng, slot)
        if self.device_photometric:
            # one sampler pass: virtual-canvas compose, x-flip and the
            # uint8 resize, after the same draws as the float path
            geo, boxes, labels = sample_expand_crop_geometry(
                (h, w), boxes, labels, rng)
            top, left, rect = geo
            flip = bool(rng.integers(2))  # random_mirror's coin
            win_w = rect[2] - rect[0]
            win_h = rect[3] - rect[1]
            if flip:
                boxes[:, [0, 2]] = win_w - boxes[:, [2, 0]]
            boxes[:, 0::2] /= win_w  # to percent
            boxes[:, 1::2] /= win_h
            img = native.fused_sample_u8(
                img, top, left, rect, flip,
                _expand_fill(self.mean, np.dtype(np.uint8)), self.size)
            return img, boxes, labels
        img = img.astype(np.float32)
        if self.photometric:
            img = photometric_distort(img, rng)
        img, boxes, labels = random_expand_crop(img, boxes, labels, rng,
                                                self.mean)
        img, boxes = random_mirror(img, boxes, rng)
        h, w, _ = img.shape
        boxes[:, 0::2] /= w  # to percent
        boxes[:, 1::2] /= h
        return resize_f32(img, self.size) - self.mean, boxes, labels
