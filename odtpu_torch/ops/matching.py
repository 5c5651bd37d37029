"""Ground truth to prior matching, batched.

Counterpart of ``odtpu/ops/matching.py`` ``match`` and ``match_batch``
(``match_second_best`` waits for the repulsion loss). Ground truth is
padded to ``[B, G]`` with label < 0 marking padding; padded rows never
match. The steps, as in ``odtpu``:

1. overlaps = IoU(truths, point_form(priors)), [B, G, P];
2. each prior's best GT and each GT's best prior (first index on ties);
3. each GT's best prior is forced to that GT, with overlap 2.0; when two
   GTs share a best prior the later one wins (a scatter-max of GT ids);
4. conf = label + 1 of the matched GT, 0 where the overlap < threshold;
5. loc = encode(matched GT, priors).

``odtpu`` gathers the matched rows with a one-hot matmul because TPU
gathers are slow; here it is plain indexing, which is exact.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .boxes import encode, jaccard, point_form


@torch.no_grad()
def match_batch(truths: Tensor, labels: Tensor, priors: Tensor, variances,
                threshold: float) -> tuple[Tensor, Tensor, Tensor]:
    """Match a batch of padded GT against all priors.

    Args:
        truths: [B, G, 4] point-form GT boxes (padding rows arbitrary).
        labels: [B, G] int labels in [0, C-2]; < 0 marks padding.
        priors: [P, 4] center-size priors, or [B, P, 4]: each image's
            own (RefineDet's refined anchors, which ``odtpu`` vmaps
            ``match`` over).
    Returns:
        loc_t [B, P, 4] encoded targets, conf_t [B, P] int64 (0 =
        background, else label + 1), best_truth_idx [B, P] int64.
    """
    B, G, _ = truths.shape
    P = priors.shape[-2]
    valid = labels >= 0
    overlaps = jaccard(truths, point_form(priors))  # [B, G, P]
    overlaps = torch.where(valid[..., None], overlaps, -1.0)

    best_prior_idx = torch.argmax(overlaps, dim=2)  # [B, G]
    best_truth_overlap = torch.amax(overlaps, dim=1)  # [B, P]
    best_truth_idx = torch.argmax(overlaps, dim=1)  # [B, P]

    # forced_gt[b, p] = the largest valid j with best_prior_idx[b, j] == p:
    # scatter-max, so duplicate indices have a defined winner on CUDA too
    gt_ids = torch.arange(G, device=truths.device).expand(B, G)
    forced_gt = torch.full((B, P), -1, dtype=torch.int64,
                           device=truths.device)
    forced_gt.scatter_reduce_(1, best_prior_idx,
                              torch.where(valid, gt_ids, -1),
                              reduce="amax", include_self=True)
    forced = forced_gt >= 0
    best_truth_idx = torch.where(forced, forced_gt, best_truth_idx)
    best_truth_overlap = torch.where(forced, 2.0, best_truth_overlap)

    matches = torch.gather(truths, 1,
                           best_truth_idx[..., None].expand(B, P, 4))
    conf = torch.gather(labels.long(), 1, best_truth_idx) + 1
    conf = torch.where(best_truth_overlap < threshold, 0, conf)
    loc = encode(matches, priors, variances)
    return loc, conf, best_truth_idx


def match(truths: Tensor, labels: Tensor, priors: Tensor, variances,
          threshold: float) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`match_batch` for one image: [G, 4], [G] -> [P, 4], [P], [P]."""
    loc, conf, idx = match_batch(truths[None], labels[None], priors,
                                 variances, threshold)
    return loc[0], conf[0], idx[0]
