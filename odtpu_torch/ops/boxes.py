"""Box math: point form, center-size, overlaps, encode and decode.

Counterpart of ``odtpu/ops/boxes.py`` (all but ``iog``, which waits for
the repulsion loss). Every function broadcasts over leading batch dims.
Conventions:
- point form:  [x_min, y_min, x_max, y_max], normalized to [0, 1];
- center-size: [cx, cy, w, h];
- priors are center-size; ground truth is point form.
"""

from __future__ import annotations

import torch
from torch import Tensor


def point_form(boxes: Tensor) -> Tensor:
    """center-size [..., 4] -> point form [..., 4]."""
    cxcy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1)


def center_size(boxes: Tensor) -> Tensor:
    """point form [..., 4] -> center-size [..., 4]."""
    mins, maxs = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(maxs + mins) / 2, maxs - mins], dim=-1)


def area(boxes: Tensor) -> Tensor:
    """Point-form box area [..., N], negative extents clamped to 0."""
    wh = torch.clamp(boxes[..., 2:] - boxes[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def intersect(box_a: Tensor, box_b: Tensor) -> Tensor:
    """Pairwise intersection area: [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    ix = (torch.minimum(box_a[..., :, None, 2], box_b[..., None, :, 2])
          - torch.maximum(box_a[..., :, None, 0], box_b[..., None, :, 0]))
    iy = (torch.minimum(box_a[..., :, None, 3], box_b[..., None, :, 3])
          - torch.maximum(box_a[..., :, None, 1], box_b[..., None, :, 1]))
    return torch.clamp(ix, min=0.0) * torch.clamp(iy, min=0.0)


def jaccard(box_a: Tensor, box_b: Tensor) -> Tensor:
    """Pairwise IoU of point-form boxes: [..., A, 4] x [..., B, 4] ->
    [..., A, B]. Areas are unclamped, as in ``odtpu``."""
    inter = intersect(box_a, box_b)
    area_a = (box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1])
    area_b = (box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union


def encode(matched: Tensor, priors: Tensor, variances) -> Tensor:
    """Matched point-form GT [..., N, 4] against center-size priors ->
    variance-scaled regression targets [..., N, 4].

    Keeps ``odtpu``'s ``log(wh_ratio + 1e-10)`` (boxes.py:94), so a
    degenerate GT side gives a finite target."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(g_wh + 1e-10) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(loc: Tensor, priors: Tensor, variances) -> Tensor:
    """Regression output [..., P, 4] against center-size priors -> point
    form boxes, in ``odtpu``'s order of operations."""
    cxcy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = cxcy - wh / 2
    maxs = mins + wh
    return torch.cat([mins, maxs], dim=-1)


def log_sum_exp(x: Tensor) -> Tensor:
    """logsumexp over the last axis, keepdim."""
    return torch.logsumexp(x, dim=-1, keepdim=True)
