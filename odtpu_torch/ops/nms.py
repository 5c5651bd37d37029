"""Fixed-shape greedy NMS in plain torch.

Counterpart of ``odtpu/ops/nms.py``, the reference's
greedy while-loop (lib/layers/box_utils.py:279) restated as a fixed
program: take the top-k candidates by score, build the [K, K] IoU matrix
once, then run K sequential mask updates in which a live candidate kills
every later one with IoU > threshold. Every function here also takes
leading batch dims, so one call runs many independent candidate sets.

This is the detect path's reference: it divides (``inter / union``) as
``odtpu.ops.nms`` does. The CUDA kernel and its plain twin
(``ops/cuda/nms_kernel.py``) use the division-free test instead.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .topk import top_k_exact


def _iou_matrix(boxes: Tensor) -> Tensor:
    """[..., K, 4] point form -> [..., K, K] IoU with the reference's
    union (areas unclipped, intersection clamped at 0)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1, min=0.0)
    h = torch.clamp(yy2 - yy1, min=0.0)
    inter = w * h
    union = areas[..., :, None] + areas[..., None, :] - inter
    return inter / union


def _greedy_mask(top_boxes: Tensor, top_scores: Tensor, iou_thresh: float,
                 score_thresh: float) -> Tensor:
    """[..., K] alive mask after greedy suppression of score-sorted
    candidates; entries with score <= score_thresh are dead on arrival."""
    k = top_scores.shape[-1]
    thresh = torch.tensor(iou_thresh, dtype=torch.float32)
    over = _iou_matrix(top_boxes) > thresh.to(top_boxes.device)
    idx = torch.arange(k, device=top_boxes.device)
    over &= idx[None, :] > idx[:, None]  # only later candidates die
    alive = top_scores > torch.tensor(score_thresh, dtype=top_scores.dtype)
    for i in range(k):
        alive = alive & ~(alive[..., i, None] & over[..., i, :])
    return alive


def nms_rows(boxes: Tensor, scores: Tensor, iou_thresh: float, top_k: int,
             score_thresh: float = 0.0) -> tuple[Tensor, Tensor]:
    """Greedy NMS -> packed rows.

    [..., N, 4], [..., N] -> ([..., top_k, 5] rows (score, x1, y1, x2,
    y2), descending score, zero padded; int32 [...] kept count).
    """
    n = scores.shape[-1]
    k = min(top_k, n)
    top_scores, order = top_k_exact(scores, k)
    top_boxes = torch.gather(
        boxes, -2, order[..., None].expand(*order.shape, 4))
    alive = _greedy_mask(top_boxes, top_scores, iou_thresh, score_thresh)
    # kept candidates to the front, in score order
    perm = torch.sort((~alive).to(torch.uint8), dim=-1, stable=True)[1]
    a = torch.gather(alive, -1, perm).to(top_scores.dtype)
    row_scores = torch.gather(top_scores, -1, perm) * a
    row_boxes = torch.gather(
        top_boxes, -2, perm[..., None].expand(*perm.shape, 4)) * a[..., None]
    rows = torch.cat([row_scores[..., None], row_boxes], dim=-1)
    if k < top_k:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, top_k - k))
    return rows, alive.sum(-1, dtype=torch.int32)


def nms(boxes: Tensor, scores: Tensor, iou_thresh: float, top_k: int = 200,
        score_thresh: float = 0.0):
    """Greedy NMS over one set (or a batch of sets) of boxes.

    Returns (keep_boxes [..., top_k, 4], keep_scores [..., top_k],
    count [...]), descending score, zero padded.
    """
    rows, count = nms_rows(boxes, scores, iou_thresh, top_k, score_thresh)
    return rows[..., 1:], rows[..., 0], count


def nms_mask(boxes: Tensor, scores: Tensor, iou_thresh: float,
             score_thresh: float = 0.0) -> Tensor:
    """Greedy-NMS alive mask of UNSORTED candidates, aligned with them.

    [..., N, 4], [..., N] -> bool [..., N]: a stable descending argsort,
    the greedy mask on the sorted candidates, then the inverse
    permutation (``odtpu.ops.nms.nms_mask``). Not to be confused with
    :func:`odtpu_torch.ops.cuda.nms_kernel.nms_mask`, which takes
    candidates already sorted by score and returns their mask in that
    order.
    """
    n = scores.shape[-1]
    order = torch.argsort(-scores, dim=-1, stable=True)
    top_boxes = torch.gather(
        boxes, -2, order[..., None].expand(*order.shape, 4))
    top_scores = torch.gather(scores, -1, order)
    alive_sorted = _greedy_mask(top_boxes, top_scores, iou_thresh,
                                score_thresh)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=order.device).expand_as(order))
    return torch.gather(alive_sorted, -1, inv)
