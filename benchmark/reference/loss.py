"""The SSD multibox loss, plain float32: matching, smooth-L1 on the
positives and softmax cross-entropy with hard-negative mining.

Matching: IoU of every ground-truth box with every prior (point form);
each prior takes its best box (the first on ties), each box's best prior
is forced to that box (a later box wins a shared prior), and a prior
whose best IoU is under ``overlap_thresh`` is background. Mining: the
negatives ranked by their cross-entropy (a stable descending sort,
positives counting 0), the first ``min(neg_pos_ratio * positives, P -
1)`` of an image kept. The loss is ``(loc_weight * smooth_l1 + ce) /
max(positives in the batch, 1)``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .common import encode, iou, point_form


@torch.no_grad()
def match(truths: Tensor, labels: Tensor, pri: Tensor, variances,
          thresh: float) -> tuple[Tensor, Tensor]:
    """[B, G, 4] point-form boxes, [B, G] labels (< 0 pads), priors
    [P, 4] -> (loc targets [B, P, 4], class targets [B, P])."""
    B, G, _ = truths.shape
    valid = labels >= 0
    overlaps = iou(truths, point_form(pri))  # [B, G, P]
    overlaps = torch.where(valid[..., None], overlaps, -1.0)
    best_prior = overlaps.argmax(2)
    best_overlap, best_truth = overlaps.max(1)
    rows = torch.arange(B, device=truths.device)
    for j in range(G):
        v = valid[:, j]
        best_truth[rows[v], best_prior[v, j]] = j
        best_overlap[rows[v], best_prior[v, j]] = 2.0
    matched = torch.gather(truths, 1, best_truth[..., None].expand(-1, -1, 4))
    conf = torch.gather(labels.long(), 1, best_truth) + 1
    conf = torch.where(best_overlap < thresh, 0, conf)
    return encode(matched, pri, variances), conf


def cross_entropy(logits: Tensor, conf_t: Tensor) -> Tensor:
    """Softmax cross-entropy of each prior's target class, [B, P]."""
    return torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, conf_t[..., None])[..., 0]


@torch.no_grad()
def hard_negatives(logits: Tensor, conf_t: Tensor, cfg: dict) -> Tensor:
    """The negatives that mining keeps from these class logits, bool
    [B, P]."""
    ce = cross_entropy(logits.float(), conf_t)
    pos = conf_t > 0
    P = ce.shape[1]
    ce_neg = torch.where(pos, 0.0, ce)
    order = torch.sort(ce_neg, dim=1, descending=True, stable=True)[1]
    rank = torch.argsort(order, dim=1)
    num_neg = torch.clamp(int(cfg["neg_pos_ratio"]) * pos.sum(1), max=P - 1)
    return (rank < num_neg[:, None]) & ~pos


def multibox(loc: Tensor, logits: Tensor, loc_t: Tensor, conf_t: Tensor,
             cfg: dict, neg: Tensor | None = None) -> Tensor:
    """The batch's loss from predictions and matched targets; ``neg``
    replaces the negatives mined from ``logits``."""
    ce = cross_entropy(logits, conf_t)
    pos = conf_t > 0
    if neg is None:
        neg = hard_negatives(logits, conf_t, cfg)
    d = (loc - loc_t).abs()
    l1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    loss_l = torch.where(pos[..., None], l1, 0.0).sum()
    loss_c = torch.where(pos | neg, ce, 0.0).sum()
    n = torch.clamp(pos.sum(), min=1).float()
    return (float(cfg["loc_weight"]) * loss_l + loss_c) / n
