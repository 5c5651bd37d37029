"""The numbers that decide ``correct``: what the timed path produced,
judged against the plain reference.

The check follows the timed path in two stages. The forward's outputs
(captured from the program's own calls in the window, or in the first
compared update) are held against the reference's forward of the same
inputs with the same weights; the stages after it, which rank, select
and mine and so turn rounding into different choices, are held against
the reference run on the program's own forward outputs.

Serving (per compared batch):

- ``forward_error``: the relative gap of the forward's outputs, loc and
  the log class probabilities taken together: ``|program - reference|``
  (Frobenius, over the batch) over ``|reference|``;
- ``detect_mismatch``: the images whose rows [R, 6] or ``dropped``
  differ in any value from the reference's decode, per-class top-k,
  greedy NMS and cross-class rows run on the program's own loc and
  class probabilities (an exact comparison).

Training (the first updates the window's step makes, against the
reference's from the same weights, batches and photometric draws):

- ``forward_error``: as above, of the first update's forward (loc and
  the class logits, together);
- ``loss_gap``: the relative gap of the first update's loss (every
  compared update's loss must be finite);
- ``grad_gap``: the first gradient as the optimizer got it, leaf by
  leaf: the gap between the program's norm and the reference's, over
  the larger of the reference's norm of that leaf and of the median
  leaf; the median leaf's gap (the worst leaf's is the noise of the few
  negatives that mining swaps on rounding, in the heads' small leaves);
- ``update_gap``: the same gap for each leaf's change after the compared
  updates, the worst leaf's, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's (they move by
  weight decay and round-off alone).

A configuration's ``limits`` name the numbers it compares.
:func:`rows_missing` is a reading for the look at the end-to-end rows
(``benchmark.calibrate``), not a compared number.
"""

from __future__ import annotations

import torch

SERVE_NUMBERS = ("forward_error", "detect_mismatch")
TRAIN_NUMBERS = ("forward_error", "loss_gap", "grad_gap", "update_gap")


def rel_gap(program: torch.Tensor, ref: torch.Tensor) -> float:
    """|program - ref| / |ref| (Frobenius, in float64); infinite where
    the shapes differ or a value is not finite."""
    if program.shape != ref.shape:
        return float("inf")
    gap = float(torch.linalg.vector_norm((program.double() - ref.double())
                                         .flatten()))
    norm = float(torch.linalg.vector_norm(ref.double().flatten()))
    return gap / norm if gap == gap else float("inf")


def forward_error(program: tuple, ref: tuple, probs: bool = False) -> float:
    """The relative gap of the outputs (loc, class scores) taken
    together; class probabilities (``probs``) in log space, where their
    gaps are the logits' own."""
    def joint(out):
        loc, conf = out
        conf = conf.double().log() if probs else conf.double()
        return torch.cat([loc.double().flatten(), conf.flatten()])
    if any(p.shape != r.shape for p, r in zip(program, ref)):
        return float("inf")
    return rel_gap(joint(program), joint(ref))


def detect_mismatch(rows, dropped, ref_rows, ref_dropped) -> int:
    """Images whose rows or ``dropped`` differ in any value (-0 equals
    0, NaN equals NaN)."""
    if rows.shape != ref_rows.shape or dropped.shape != ref_dropped.shape:
        return rows.shape[0]
    a, b = rows.float(), ref_rows.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    bad = ~same.flatten(1).all(1) | (dropped.long() != ref_dropped.long())
    return int(bad.sum())


def rows_missing(rows, ref_rows, min_iou: float = 0.9) -> float:
    """The share of the reference's rows (score above 0) that the
    program's rows of the same image lack: no row of the same class
    whose box overlaps at ``min_iou`` or more."""
    from .reference.common import iou
    live = ref_rows[..., 0] > 0
    if not bool(live.any()):
        return 0.0
    same = ref_rows[..., :, None, 5] == rows[..., None, :, 5]
    near = iou(ref_rows[..., 1:5], rows[..., 1:5]) >= min_iou
    found = (same & near & (rows[..., None, :, 0] > 0)).any(-1)
    return float((live & ~found).sum()) / float(live.sum())


def leaf_gap(program: torch.Tensor, ref: torch.Tensor,
             keep: torch.Tensor | None = None) -> torch.Tensor:
    """Per-leaf norms [L] -> each leaf's |program - ref| over max(ref,
    median ref), over the leaves ``keep`` marks."""
    gap = (program - ref).abs() / torch.clamp(ref, min=float(ref.median()))
    return gap if keep is None else gap[keep]


def train_numbers(program: dict, ref: dict) -> dict:
    """``program`` and ``ref``: ``losses`` of each compared update,
    ``forward`` (the first update's outputs), per-leaf norms ``grad``
    (first gradient) and ``change`` (after the compared updates)."""
    lp = torch.as_tensor(program["losses"], dtype=torch.float64)
    lr = torch.as_tensor(ref["losses"], dtype=torch.float64)
    keep = ref["grad"] >= 1e-3 * ref["grad"].median()
    loss_gap = float((lp[0] - lr[0]).abs() / lr[0].abs())
    if not bool(torch.isfinite(lp).all()):
        loss_gap = float("inf")
    return {"forward_error": forward_error(program["forward"],
                                           ref["forward"]),
            "loss_gap": loss_gap,
            "grad_gap": float(leaf_gap(program["grad"],
                                       ref["grad"]).median()),
            "update_gap": float(leaf_gap(program["change"], ref["change"],
                                         keep).max())}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at most its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
