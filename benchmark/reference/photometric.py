"""The photometric distortion of SSD's training augmentation, plain
float32, per image: brightness +-32 (p = .5), contrast x[.5, 1.5]
before or after the HSV block (p = .5 each way), saturation x[.5, 1.5]
(p = .5), hue +-18 degrees (p = .5), a channel permutation (p = .5);
then the mean subtracted and BGR turned to RGB.

The draw: a device generator seeded ``(17 << 32) + step``, read in the
order ``DRAWS`` lists (a coin is ``rand < 0.5``, a range ``lo + (hi - lo)
* rand``, the permutation ``randint(0, 6)``).
"""

from __future__ import annotations

import torch
from torch import Tensor

PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

# name -> None for a coin, (lo, hi) for a range, "perm"
DRAWS = (("do_brightness", None), ("delta", (-32.0, 32.0)),
         ("contrast_first", None), ("alpha", (0.5, 1.5)),
         ("do_contrast", None), ("saturation", (0.5, 1.5)),
         ("do_saturation", None), ("hue", (-18.0, 18.0)),
         ("do_hue", None), ("perm", "perm"), ("do_perm", None))


def draw(batch: int, step: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed((17 << 32) + int(step))
    out = {}
    for name, kind in DRAWS:
        if kind == "perm":
            out[name] = torch.randint(0, 6, (batch,), generator=g,
                                      device=device)
            continue
        u = torch.rand(batch, generator=g, device=device)
        out[name] = u < 0.5 if kind is None else kind[0] + (
            kind[1] - kind[0]) * u
    return out


def _hsv(b, g, r):
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp(min=1e-10), 0.0)
    dd = d.clamp(min=1e-10)
    rc, gc, bc = (mx - r) / dd, (mx - g) / dd, (mx - b) / dd
    h = torch.where(r == mx, bc - gc,
                    torch.where(g == mx, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d == 0, 0.0, torch.remainder(h * 60.0, 360.0))
    return h, s, mx


def _bgr(h, s, v):
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int64), 6)
    table = torch.stack([torch.stack(c, -1) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))],
        -2)  # [..., 6, 3] as (r, g, b)
    rgb = torch.gather(table, -2, i[..., None, None].expand(
        *i.shape, 1, 3))[..., 0, :]
    return rgb[..., 2], rgb[..., 1], rgb[..., 0]


def preprocess(images: Tensor, params: dict, means) -> Tensor:
    """uint8 BGR [B, H, W, 3] -> distorted, mean-subtracted RGB float32."""
    x = images.float()
    p = {k: v[:, None, None] for k, v in params.items()}
    b, g, r = x.unbind(-1)
    b, g, r = (torch.where(p["do_brightness"], c + p["delta"], c)
               for c in (b, g, r))
    first = p["contrast_first"] & p["do_contrast"]
    b, g, r = (torch.where(first, c * p["alpha"], c) for c in (b, g, r))
    h, s, v = _hsv(b, g, r)
    s = s * torch.where(p["do_saturation"], p["saturation"], 1.0)
    h = h + torch.where(p["do_hue"], p["hue"], 0.0)
    b, g, r = _bgr(h, s, v)
    last = ~p["contrast_first"] & p["do_contrast"]
    planes = torch.stack([torch.where(last, c * p["alpha"], c)
                          for c in (b, g, r)], -1)
    perm = torch.tensor(PERMS, device=x.device)[params["perm"]]
    permuted = torch.gather(planes, -1, perm[:, None, None, :].expand_as(
        planes).contiguous())
    planes = torch.where(p["do_perm"][..., None], permuted, planes)
    mean = torch.tensor([float(m) for m in means], device=x.device)
    return (planes - mean).flip(-1)
