"""The SSD multibox loss: smooth-L1 on positives plus mined softmax CE.

Counterpart of ``odtpu/layers/losses.py`` ``smooth_l1``,
``multibox_targets``, ``multibox_loss``, ``mined_multibox``,
``MultiBoxLoss``, ``RefineDetLossOutput`` and ``refinedet_loss``
(``focal_loss`` and ``repulsion_loss`` wait for their slice). The sums
are unnormalized and come with the positive count, so the train step
divides by the whole batch's N.

Hard negative mining keeps ``odtpu``'s rank rule: a stable descending
sort of the negatives' CE (positives and ignored priors count 0), and a
negative is mined when its rank is below ``min(neg_pos_ratio * num_pos,
P - 1)``. The rank is the sort's inverse permutation, made by a scatter
(a permutation has no duplicate indices, so the scatter is exact on any
device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..models.common import float32_or_wider
from ..ops.detect import refine_anchors
from ..ops.matching import match_batch


class MultiBoxLossOutput(NamedTuple):
    loss_loc_sum: Tensor   # scalar, unnormalized smooth-L1 over positives
    loss_conf_sum: Tensor  # scalar, unnormalized mined CE
    num_pos: Tensor        # scalar int, positives in the batch


def smooth_l1(x: Tensor) -> Tensor:
    """Elementwise smooth-L1 (beta = 1), summed by callers."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_targets(gt_boxes: Tensor, gt_labels: Tensor, priors: Tensor,
                     variances, overlap_thresh: float):
    """Batched matching: [B, G, 4], [B, G] -> (loc_t [B, P, 4], conf_t
    [B, P]), outside the autograd graph."""
    loc_t, conf_t, _ = match_batch(gt_boxes, gt_labels, priors, variances,
                                   overlap_thresh)
    return loc_t, conf_t


def mining_masks(ce: Tensor, conf_t: Tensor, neg_pos_ratio: int = 3,
                 ignore: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Positive and mined-negative masks [B, P] from the per-prior CE.
    ``ignore`` [B, P] bool takes priors out of the negative pool only."""
    P = ce.shape[1]
    pos = conf_t > 0
    num_pos = pos.sum(1)
    excluded = pos if ignore is None else pos | ignore
    ce_neg = torch.where(excluded, 0.0, ce.detach())
    loss_idx = torch.argsort(-ce_neg, dim=1, stable=True)
    rank = torch.empty_like(loss_idx).scatter_(
        1, loss_idx, torch.arange(P, device=ce.device).expand_as(loss_idx))
    num_neg = torch.clamp(neg_pos_ratio * num_pos, max=P - 1)
    neg = (rank < num_neg[:, None]) & ~excluded
    return pos, neg


def mined_multibox(loc_pred: Tensor, conf_pred: Tensor, loc_t: Tensor,
                   conf_t: Tensor, neg_pos_ratio: int = 3,
                   ignore: Tensor | None = None) -> MultiBoxLossOutput:
    """Smooth-L1 + hard-negative-mined CE from precomputed targets, in
    float32 whatever the predictions' dtype (in float64 for a float64
    step).

    ``ignore``: optional [B, P] bool, priors left out of the negative
    mining pool (RefineDet's negative anchor filtering); positives always
    train, as in ``odtpu`` (losses.py:77-121)."""
    logits = float32_or_wider(conf_pred)
    lse = torch.logsumexp(logits, dim=-1)
    # the target's logit by a gather: the value odtpu's one-hot reduce
    # computes (its reduce is a TPU workaround)
    tgt = torch.where(conf_t > 0, conf_t, 0)
    ce = lse - torch.gather(logits, -1, tgt[..., None])[..., 0]
    pos, neg = mining_masks(ce, conf_t, neg_pos_ratio, ignore)

    loc_err = smooth_l1(float32_or_wider(loc_pred) - loc_t)
    loss_l = torch.where(pos[..., None], loc_err, 0.0).sum()
    loss_c = torch.where(pos | neg, ce, 0.0).sum()
    return MultiBoxLossOutput(loss_l, loss_c, pos.sum())


def multibox_loss(loc_pred: Tensor, conf_pred: Tensor, priors: Tensor,
                  gt_boxes: Tensor, gt_labels: Tensor, variances,
                  overlap_thresh: float = 0.5, neg_pos_ratio: int = 3
                  ) -> MultiBoxLossOutput:
    """SSD loss, unnormalized.

    Args:
        loc_pred:  [B, P, 4] raw loc predictions.
        conf_pred: [B, P, C] raw class logits.
        priors:    [P, 4] center-size priors.
        gt_boxes:  [B, G, 4] point-form GT, padded.
        gt_labels: [B, G] labels in [0, C-2]; < 0 marks padding.
    """
    loc_t, conf_t = multibox_targets(gt_boxes, gt_labels, priors, variances,
                                     overlap_thresh)
    return mined_multibox(loc_pred, conf_pred, loc_t, conf_t, neg_pos_ratio)


class MultiBoxLoss:
    """The reference's call contract: ``MultiBoxLoss(cfg)((loc, conf,
    priors), (boxes, labels))`` -> (loss_l, loss_c), each divided by the
    positive count (at least 1)."""

    def __init__(self, cfg):
        self.variance = tuple(float(v) for v in cfg.MODEL.VARIANCE)
        self.threshold = float(cfg.LOSS.OVERLAP_THRESH)
        self.negpos_ratio = int(cfg.LOSS.NEG_POS_RATIO)

    def __call__(self, predictions, targets):
        loc, conf, priors = predictions
        boxes, labels = targets
        out = multibox_loss(loc, conf, priors, boxes, labels, self.variance,
                            self.threshold, self.negpos_ratio)
        n = torch.clamp(out.num_pos, min=1).float()
        return out.loss_loc_sum / n, out.loss_conf_sum / n


class RefineDetLossOutput(NamedTuple):
    arm: MultiBoxLossOutput
    odm: MultiBoxLossOutput


# the box an ignored anchor takes for the ODM's matching: far outside
# [0, 1], so its IoU with every GT is 0 (odtpu losses.py:224)
_DEGENERATE = (-4.0, -4.0, 1e-3, 1e-3)


def refinedet_loss(arm_loc: Tensor, arm_conf: Tensor, odm_loc: Tensor,
                   odm_conf: Tensor, priors: Tensor, gt_boxes: Tensor,
                   gt_labels: Tensor, variances,
                   overlap_thresh: float = 0.5, neg_pos_ratio: int = 3,
                   neg_anchor_thresh: float = 0.99,
                   use_refined: bool = True) -> RefineDetLossOutput:
    """RefineDet's two-step loss (arXiv:1711.06897 §3), unnormalized.

    ARM: a class-agnostic multibox loss against the anchor grid (every GT
    label collapsed to one object class). ODM: the C-class mined loss
    against each image's refined anchors (:func:`refine_anchors`,
    outside autograd). Anchors whose ARM background probability passes
    ``neg_anchor_thresh`` are ignored: they match as a degenerate box,
    take target 0 (the forced match can still pin a GT to one), and leave
    the ODM's negative pool. With ``use_refined`` False (the warm phase
    of ``LOSS.ODM_MATCH_WARM_ITERS``) the ODM matches against the raw
    anchors with nothing ignored.
    """
    bin_labels = torch.where(gt_labels >= 0, 0, -1)
    arm = multibox_loss(arm_loc, arm_conf, priors, gt_boxes, bin_labels,
                        variances, overlap_thresh, neg_pos_ratio)
    with torch.no_grad():
        if use_refined:
            anchors = refine_anchors(arm_loc, priors, variances)
            ignore = torch.softmax(arm_conf, -1)[..., 0] \
                > neg_anchor_thresh
            anchors = torch.where(ignore[..., None], anchors.new_tensor(
                _DEGENERATE), anchors)
        else:
            anchors = priors
            ignore = torch.zeros(arm_conf.shape[:2], dtype=torch.bool,
                                 device=arm_conf.device)
        loc_t, conf_t, _ = match_batch(gt_boxes, gt_labels, anchors,
                                       variances, overlap_thresh)
        conf_t = torch.where(ignore, 0, conf_t)
    odm = mined_multibox(odm_loc, odm_conf, loc_t, conf_t, neg_pos_ratio,
                         ignore=ignore)
    return RefineDetLossOutput(arm, odm)
