"""On-device photometric augmentation of a uint8 train batch.

Counterpart of ``odtpu/data/device_aug.py``: the photometric half of
SSDAugmentation (ConvertFromInts, PhotometricDistort, SubtractMeans and
the BGR -> RGB flip) on the device, per image, with the reference's
distributions (augmentations.py:357-378): brightness +-32 (p=.5),
contrast x[.5, 1.5] before OR after the HSV block (p=.5 each side),
saturation x[.5, 1.5] (p=.5), hue +-18 degrees (p=.5), a channel
permutation (p=.5). HSV is exact float RGB <-> HSV, H in degrees.

It is split in two: :func:`draw_params` draws each image's parameters
from a ``torch.Generator``, and :func:`apply` applies given parameters.
Tests feed ``odtpu``'s own draws into :func:`apply`; the two frameworks'
generators give different numbers from one seed.

The math runs on [B, H, W] planes, in ``odtpu``'s order of operations.
"""

from __future__ import annotations

import torch
from torch import Tensor

_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

# the per-image parameters: name -> dtype
PARAMS = {"do_brightness": torch.bool, "delta": torch.float32,
          "contrast_first": torch.bool, "alpha": torch.float32,
          "do_contrast": torch.bool, "saturation": torch.float32,
          "do_saturation": torch.bool, "hue": torch.float32,
          "do_hue": torch.bool, "perm": torch.int64, "do_perm": torch.bool}


def draw_params(batch: int, generator: torch.Generator) -> dict:
    """Each image's distortion parameters, [batch] tensors on the
    generator's device."""
    dev = generator.device

    def coin():
        return torch.rand(batch, generator=generator, device=dev) < 0.5

    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator, device=dev)
        return lo + (hi - lo) * u

    return {"do_brightness": coin(), "delta": uniform(-32.0, 32.0),
            "contrast_first": coin(), "alpha": uniform(0.5, 1.5),
            "do_contrast": coin(), "saturation": uniform(0.5, 1.5),
            "do_saturation": coin(), "hue": uniform(-18.0, 18.0),
            "do_hue": coin(),
            "perm": torch.randint(0, 6, (batch,), generator=generator,
                                  device=dev),
            "do_perm": coin()}


def _rgb_to_hsv_planes(b: Tensor, g: Tensor, r: Tensor):
    """BGR float planes (0-255 scale) -> (H degrees, S 0-1, V 0-255)."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-10), 0.0)
    safe = torch.clamp(delta, min=1e-10)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    # Python's % (the divisor's sign), not C's fmod: hues go negative
    h = torch.remainder(h * 60.0, 360.0)
    h = torch.where(delta == 0, 0.0, h)
    return h, s, v


def _select(i: Tensor, choices):
    """choices[i] elementwise, for i in [0, len(choices))."""
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def _hsv_to_rgb_planes(h: Tensor, s: Tensor, v: Tensor):
    """Inverse of :func:`_rgb_to_hsv_planes`; returns (b, g, r) planes."""
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, (v, q, p, p, t, v))
    g = _select(i, (t, v, v, q, p, p))
    b = _select(i, (p, p, t, v, v, q))
    return b, g, r


def apply(images: Tensor, params: dict) -> Tensor:
    """Photometric distortion of raw BGR float images [B, H, W, 3]
    (0-255 scale) with per-image ``params`` (see :func:`draw_params`)."""
    x = {k: params[k].to(images.device)[:, None, None] for k in PARAMS}
    planes = images.unbind(-1)  # b, g, r
    planes = [torch.where(x["do_brightness"], p + x["delta"], p)
              for p in planes]
    first = x["contrast_first"] & x["do_contrast"]
    planes = [torch.where(first, p * x["alpha"], p) for p in planes]
    h, s, v = _rgb_to_hsv_planes(*planes)
    s = s * torch.where(x["do_saturation"], x["saturation"], 1.0)
    h = h + torch.where(x["do_hue"], x["hue"], 0.0)
    planes = _hsv_to_rgb_planes(h, s, v)
    last = ~x["contrast_first"] & x["do_contrast"]
    planes = [torch.where(last, p * x["alpha"], p) for p in planes]
    perm = torch.tensor(_PERMS, device=images.device)[x["perm"][..., 0, 0]]
    permuted = [_select(perm[:, c, None, None], planes) for c in range(3)]
    planes = [torch.where(x["do_perm"], pc, p)
              for pc, p in zip(permuted, planes)]
    return torch.stack(planes, dim=-1)


def preprocess_train_batch(images_u8: Tensor, params: dict | None, mean,
                           distort: bool = True,
                           dtype: torch.dtype = torch.float32) -> Tensor:
    """uint8 BGR [B, H, W, 3] -> RGB in ``dtype`` (float32, or float64 for
    a float64 step), mean subtracted, with the photometric distortion by
    ``params`` when ``distort``."""
    img = images_u8.to(dtype)
    if distort:
        img = apply(img, params)
    img = img - torch.tensor([float(m) for m in mean], device=img.device)
    return img.flip(-1)
