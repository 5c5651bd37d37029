"""Detection output, plain float32: decode, per-class top-k, greedy NMS,
the cross-class rows and ``dropped``.

For each image and each foreground class c: the ``top_k`` highest
class-c scores (a stable descending sort: the smaller prior index first
among equals), those above ``conf_thresh`` live; in score order a live
box removes every later box whose IoU with it is above ``nms_thresh``
(IoU as ``inter / union``). The survivors of every class, ranked by
score across classes (class-major, then candidate order among equals),
give the first ``top_k`` rows (score, x1, y1, x2, y2, class); zero rows
pad. ``dropped`` counts the survivors the rows leave out. The overlap
test is ``inter > nms_thresh * union`` with a positive union, in
float32: IoU above the threshold without the rounding of a divide.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .common import decode, overlaps


def greedy_alive(boxes: Tensor, scores: Tensor, nms_thresh: float,
                 conf_thresh: float) -> Tensor:
    """Score-sorted candidate sets [N, K, 4], [N, K] -> the bool [N, K]
    mask of greedy NMS's survivors."""
    k = scores.shape[-1]
    idx = torch.arange(k, device=scores.device)
    inter, union = overlaps(boxes, boxes)
    t = torch.tensor(nms_thresh, dtype=torch.float32, device=boxes.device)
    over = ((inter > t * union) & (union > 0)
            & (idx[None, :] > idx[:, None]))
    alive = scores > conf_thresh
    for i in range(k):
        alive = alive & ~(alive[:, i, None] & over[:, i, :])
    return alive


def candidates(conf: Tensor, top_k: int) -> tuple[Tensor, Tensor]:
    """Class probabilities [B, P, C] -> each foreground class's ``top_k``
    highest scores and their prior indices, [B, C-1, K], descending."""
    fg = conf[..., 1:].transpose(1, 2)
    scores, order = torch.sort(fg, dim=-1, descending=True, stable=True)
    k = min(top_k, fg.shape[-1])
    return scores[..., :k], order[..., :k]


def detect(loc: Tensor, conf: Tensor, pri: Tensor, cfg: dict) -> dict:
    """loc [B, P, 4], class probabilities [B, P, C], priors [P, 4] ->
    ``boxes`` [B, P, 4] (decoded), ``rows`` [B, top_k, 6], ``dropped``
    [B], and the per-class candidates: ``cand_scores``, ``cand_order``,
    ``alive`` [B, C-1, K] and ``cand_boxes`` [B, C-1, K, 4]."""
    top_k = int(cfg["top_k"])
    boxes = decode(loc, pri[None], cfg["variance"])
    B, P, C = conf.shape
    scores, order = candidates(conf, top_k)
    k = scores.shape[-1]
    cand = torch.gather(boxes[:, None].expand(B, C - 1, P, 4), 2,
                        order[..., None].expand(B, C - 1, k, 4))
    alive = greedy_alive(cand.reshape(-1, k, 4), scores.reshape(-1, k),
                         cfg["nms_thresh"], cfg["conf_thresh"])
    alive = alive.reshape(B, C - 1, k)
    kept = torch.where(alive, scores, 0.0)
    cls = torch.arange(1, C, dtype=torch.float32, device=conf.device)
    flat = torch.cat([kept[..., None], cand,
                      cls[None, :, None, None].expand(B, C - 1, k, 1)], -1)
    flat = flat.reshape(B, -1, 6)
    rank = torch.sort(flat[..., 0], dim=1, descending=True, stable=True)[1]
    rows = torch.gather(flat, 1, rank[:, :top_k, None].expand(-1, -1, 6))
    rows = rows * (rows[..., :1] > 0)
    if rows.shape[1] < top_k:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, top_k - rows.shape[1]))
    dropped = alive.sum((1, 2)) - (rows[..., 0] > 0).sum(1)
    return {"boxes": boxes, "rows": rows, "dropped": dropped,
            "cand_scores": scores, "cand_order": order, "alive": alive,
            "cand_boxes": cand}
