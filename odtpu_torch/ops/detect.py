"""Detection output: decode + per-class greedy NMS + cross-class rows.

Counterpart of ``odtpu/ops/detect.py`` (lines 76-263), RefineDet's
two-step ``detect_refine`` included. The dense contract is the
reference's (lib/layers/functions/detection.py DetectOut:6):

    output[b, c, k] = [score, x1, y1, x2, y2]   for c in 1..C-1

rows zeroed beyond the per-class keep count, class 0 (background) all
zeros. :func:`detect_out_compact` returns the cross-class top rows
``[B, top_k, 6]`` with the class id as the last column.

``odtpu``'s ``_per_class_nms`` is :func:`ops.cuda.nms_kernel.per_class_nms`
here, and every batch size goes through it (the CUDA kernel for CUDA
tensors). ``odtpu``'s TPU routing and padding (``_resolve_impl``,
``_PALLAS_MIN_SETS``) have no counterpart.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .boxes import center_size, decode
from .cuda.nms_kernel import per_class_nms
from .nms import nms_rows
from .topk import top_k_exact


def _per_class_nms_reference(decoded: Tensor, conf_fg: Tensor,
                             conf_thresh: float, nms_thresh: float,
                             top_k: int) -> Tensor:
    """The same rows as :func:`per_class_nms`, from the plain
    :func:`ops.nms.nms_rows` on every (image, class) set: ``odtpu``'s
    lax path, which divides in its IoU test. Tests and ``chip_smoke.py``
    hold the kernel path to it."""
    B, P, _ = decoded.shape
    Cf = conf_fg.shape[-1]
    boxes = decoded[:, None].expand(B, Cf, P, 4)
    rows, _ = nms_rows(boxes, conf_fg.transpose(1, 2), nms_thresh, top_k,
                       conf_thresh)
    return rows


def _finalize(out_fg: Tensor, top_k: int, cross_class_topk: bool) -> Tensor:
    """Prepend the zero background class; optional global rank filter."""
    B = out_fg.shape[0]
    C = out_fg.shape[1] + 1
    background = out_fg.new_zeros((B, 1, top_k, 5))
    output = torch.cat([background, out_fg], dim=1)
    if cross_class_topk:
        flat = output.reshape(B, -1, 5)
        rank_src = torch.sort(-flat[:, :, 0], dim=1, stable=True)[1]
        rank = torch.argsort(rank_src, dim=1)
        keep = (rank < top_k)[..., None]
        output = torch.where(keep, flat, 0.0).reshape(B, C, top_k, 5)
    return output


def detect_out(loc: Tensor, conf: Tensor, priors: Tensor, variances,
               conf_thresh: float = 0.01, nms_thresh: float = 0.45,
               top_k: int = 200, cross_class_topk: bool = False,
               row_compact: bool = True) -> Tensor:
    """Decode + per-class NMS for a batch.

    Args:
        loc:    [B, P, 4] location predictions.
        conf:   [B, P, C] class probabilities (already softmaxed).
        priors: [P, 4] center-size priors.
        row_compact: partition each class row survivors-first (the dense
            reference contract). Pass False when the caller re-ranks with
            :func:`_compact` anyway.
    Returns:
        [B, C, top_k, 5] float32: (score, x1, y1, x2, y2), zero padded.
    """
    return detect_decoded(*ssd_decode(loc, conf, priors, variances),
                          conf_thresh, nms_thresh, top_k, cross_class_topk,
                          row_compact)


def ssd_decode(loc: Tensor, conf: Tensor, priors: Tensor,
               variances) -> tuple[Tensor, Tensor]:
    """The single-shot detectors' decode -> (decoded [B, P, 4] point
    form, conf): ``loc`` against the shared priors [P, 4]."""
    variances = tuple(float(v) for v in variances)
    return decode(loc, priors[None], variances), conf


def detect_decoded(decoded: Tensor, conf: Tensor, conf_thresh: float,
                   nms_thresh: float, top_k: int,
                   cross_class_topk: bool = False,
                   row_compact: bool = True) -> Tensor:
    """Per-class NMS of decoded boxes [B, P, 4] (contiguous) and their
    softmaxed ``conf`` [B, P, C] -> the dense [B, C, top_k, 5]: the tail
    that :func:`detect_out` and :func:`detect_refine` share."""
    out_fg = per_class_nms(decoded, conf[..., 1:], float(conf_thresh),
                           float(nms_thresh), int(top_k),
                           compact_rows=row_compact)
    return _finalize(out_fg, int(top_k), cross_class_topk)


def survivors_first(dense: Tensor) -> Tensor:
    """Rows ``[B, C, K, 5]`` in candidate order with dead rows' scores
    zeroed (``per_class_nms(compact_rows=False)``) -> the dense contract:
    each class's survivors first, in their order, then zero rows, as
    ``compact_rows=True`` gives them (a stable top-k over the scores:
    candidates are score-sorted and scores are non-negative)."""
    B, C, K, _ = dense.shape
    scores, perm = top_k_exact(dense[..., 0].reshape(B * C, K), K)
    rows = torch.gather(dense.reshape(B * C, K, 5), 1,
                        perm[..., None].expand(-1, -1, 5))
    return (rows * (scores > 0.0)[..., None]).reshape(B, C, K, 5)


def _compact(dense: Tensor, top_k: int) -> Tensor:
    """[B, C, K, 5] -> cross-class top-k rows [B, top_k, 6] (+cls col)."""
    B, C, K, _ = dense.shape
    cls_ids = torch.arange(C, dtype=dense.dtype, device=dense.device)
    cls_ids = cls_ids[None, :, None, None].expand(B, C, K, 1)
    flat = torch.cat([dense, cls_ids], dim=-1).reshape(B, C * K, 6)
    top_scores, idx = top_k_exact(flat[:, :, 0], top_k)
    picked = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 6))
    return picked * (top_scores[..., None] > 0)


def detect_out_compact(loc: Tensor, conf: Tensor, priors: Tensor, variances,
                       conf_thresh: float = 0.01, nms_thresh: float = 0.45,
                       top_k: int = 200) -> Tensor:
    """Like :func:`detect_out` but returns the cross-class top-`top_k`
    detections per image as [B, top_k, 6] (score, x1, y1, x2, y2, cls),
    zero padded, descending score. The per-class survivors-first
    partition is skipped: the cross-class re-rank keeps the in-class
    order either way, so the rows are the same."""
    dense = detect_out(loc, conf, priors, variances, conf_thresh,
                       nms_thresh, top_k, row_compact=False)
    return _compact(dense, int(top_k))


# the BBOX_XFORM_CLIP of ``odtpu``'s refinedet_loss (losses.py:36),
# log(1000 / 16): the largest log-scale a box side may take
_XFORM_CLIP = 4.135166556742356


def refine_anchors(arm_loc: Tensor, priors: Tensor, variances) -> Tensor:
    """The ARM's refined anchors [B, P, 4], center-size: ``arm_loc``
    decoded against ``priors`` [P, 4], its log-scale clamped at
    ``_XFORM_CLIP`` (as ``odtpu`` does for an untrained net whose raw
    ``arm_loc`` would overflow exp)."""
    variances = tuple(float(v) for v in variances)
    clip = _XFORM_CLIP / variances[1]
    arm_loc = torch.cat([arm_loc[..., :2],
                         arm_loc[..., 2:].clamp(-clip, clip)], -1)
    return center_size(decode(arm_loc, priors[None], variances))


def refine_decode(arm_loc: Tensor, arm_conf: Tensor, odm_loc: Tensor,
                  odm_conf: Tensor, priors: Tensor, variances,
                  neg_anchor_thresh: float = 0.99) -> tuple[Tensor, Tensor]:
    """RefineDet's two-step decode -> (decoded [B, P, 4] point form,
    conf [B, P, C]): the ARM's offsets refine the priors
    (:func:`refine_anchors`), the ODM's offsets decode
    against each image's refined anchors, and anchors the ARM holds to be
    background (P(bg) > ``neg_anchor_thresh``, the paper's test-time
    filter) score 0."""
    refined = refine_anchors(arm_loc, priors, variances)
    decoded = decode(odm_loc, refined, variances)  # [B, P, 4], contiguous
    keep = arm_conf[..., 0] <= neg_anchor_thresh
    return decoded, odm_conf * keep[..., None]


def detect_refine(arm_loc: Tensor, arm_conf: Tensor, odm_loc: Tensor,
                  odm_conf: Tensor, priors: Tensor, variances,
                  conf_thresh: float = 0.01, nms_thresh: float = 0.45,
                  top_k: int = 200, neg_anchor_thresh: float = 0.99,
                  compact: bool = True, row_compact: bool | None = None):
    """RefineDet two-step decode (:func:`refine_decode`) + per-class NMS.

    ``arm_conf`` [B, P, 2] and ``odm_conf`` [B, P, C] must be softmaxed
    (the eval phase). Returns the cross-class rows [B, top_k, 6] when
    ``compact``, else the dense [B, C, top_k, 5]. ``row_compact``
    defaults to ``not compact``, as in :func:`detect_out`; on CUDA
    tensors ``row_compact=False`` is one ``nms_rows`` launch."""
    decoded, conf = refine_decode(arm_loc, arm_conf, odm_loc, odm_conf,
                                  priors, variances, neg_anchor_thresh)
    if row_compact is None:
        row_compact = not compact
    dense = detect_decoded(decoded, conf, conf_thresh, nms_thresh, top_k,
                           row_compact=bool(row_compact))
    return _compact(dense, int(top_k)) if compact else dense


class DetectOut:
    """Callable wrapper with the reference constructor's signature
    (detection.py:12)."""

    def __init__(self, num_classes, bkg_label, top_k, conf_thresh,
                 nms_thresh, variance):
        if nms_thresh <= 0:
            raise ValueError("nms_threshold must be non negative.")
        del num_classes, bkg_label  # implied by conf's shape / fixed 0
        self.top_k = int(top_k)
        self.conf_thresh = float(conf_thresh)
        self.nms_thresh = float(nms_thresh)
        self.variance = tuple(float(v) for v in variance)

    def __call__(self, loc, conf, priors):
        return detect_out(loc, conf, priors, self.variance,
                          conf_thresh=self.conf_thresh,
                          nms_thresh=self.nms_thresh, top_k=self.top_k)
