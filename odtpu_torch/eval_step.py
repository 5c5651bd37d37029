"""The eval step: uint8 images in, cross-class detection rows out.

Counterpart of ``make_eval_step`` in ``odtpu/parallel/train.py:227-293``:
uint8 BGR NHWC -> float32, mean subtract, BGR -> RGB (reference
det_dataset.py:49) -> forward -> the model's ``decode`` (RefineDet's is
its two-step decode, ``train.py:259-268``) -> per-class NMS, one
``nms_rows`` launch a batch on a card -> with ``EVAL.COMPACT`` (the
default) the cross-class top rows plus the ``dropped`` self-audit: how
many per-class survivors the row cap discarded (the reference keeps
every survivor, so nonzero marks a deviation); without it the dense
reference contract ``[B, C, TOP_K, 5]``, every class's survivors first
in score order (``ops.detect.survivors_first``), as ``odtpu``'s
``compact=False`` step returns it.

The forward runs the model in eval mode, as ``odtpu``'s ``train=False``
apply does: batch norm normalises with its running statistics and leaves
them as they are. A model in train mode (the train loop's) is put back
in train mode after each forward. It also runs under ``cfg.TPU.QUANT``
("" or "int8", ``models.set_quant``), as ``odtpu``'s step enters
``quantized(cfg.TPU.QUANT)`` (``train.py:249-268``), and the model's
own mode is put back after it: the train loop validates in int8 when
its config asks for it and trains in the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from . import trace
from .models.common import quant_mode, set_quant
from .ops.detect import _compact, detect_decoded, survivors_first


class EvalStep:
    """``step(images) -> {"rows": [B, R, 6], "dropped": int32 [B]}`` with
    R = ``EVAL.COMPACT_ROWS`` or ``EVAL.TOP_K``; with ``compact`` off,
    ``step(images) -> [B, C, TOP_K, 5]`` (the dense contract).
    :meth:`forward` and :meth:`detect` are the two halves, for callers
    that need loc/conf. ``compact`` defaults to ``EVAL.COMPACT``."""

    def __init__(self, model, priors: Tensor, cfg, compact=None):
        self.model = model
        self.priors = priors
        self.variances = tuple(float(v) for v in cfg.MODEL.VARIANCE)
        self.top_k = int(cfg.EVAL.TOP_K)
        self.conf_thresh = float(cfg.EVAL.CONF_THRESH)
        self.nms_thresh = float(cfg.EVAL.NMS_THRESH)
        self.rows_cap = int(cfg.EVAL.COMPACT_ROWS) or self.top_k
        self.compact = bool(cfg.EVAL.COMPACT if compact is None
                            else compact)
        self.quant = quant_mode(cfg.TPU.QUANT)
        self.means = torch.tensor([float(m) for m in cfg.DATASET.PIXEL_MEANS],
                                  dtype=torch.float32, device=priors.device)

    @trace.spanned("serve.forward")
    @torch.inference_mode()
    def forward(self, images: Tensor) -> tuple[Tensor, ...]:
        """[B, H, W, 3] images (uint8 BGR, or already normalized float)
        -> loc [B, P, 4], softmaxed conf [B, P, C], float32; RefineDet's
        arm_loc, arm_conf, odm_loc, odm_conf (both confs softmaxed)."""
        if images.dtype == torch.uint8:
            images = (images.float() - self.means).flip(-1)
        training = self.model.training
        self.model.eval()
        quant = set_quant(self.model, self.quant)
        try:
            return self.model(images, phase="eval")
        finally:
            set_quant(self.model, quant)
            self.model.train(training)

    @trace.spanned("detect.decode")
    def decode(self, *outputs: Tensor) -> tuple[Tensor, Tensor]:
        """:meth:`forward`'s outputs -> (decoded boxes [B, P, 4], conf
        [B, P, C]) by the model's own ``decode``, which the per-class NMS
        takes."""
        return self.model.decode(*outputs, self.priors, self.variances)

    @trace.spanned("serve.detect")
    @torch.inference_mode()
    def detect(self, *outputs: Tensor):
        """:meth:`forward`'s outputs -> rows and ``dropped``, or the dense
        ``[B, C, TOP_K, 5]`` with ``compact`` off."""
        # one nms_rows launch: its rows stay in candidate order, which
        # _compact re-ranks across classes (the audit counts ignore row
        # order) and survivors_first partitions within each class
        dense = detect_decoded(*self.decode(*outputs), self.conf_thresh,
                               self.nms_thresh, self.top_k,
                               row_compact=False)
        if not self.compact:
            return survivors_first(dense)
        with trace.span("detect.compact"):
            rows = _compact(dense, self.rows_cap)
            return {"rows": rows, "dropped": dropped(dense, rows)}

    @trace.spanned("serve.step", step=True)
    def __call__(self, images):
        """uint8 BGR [B, H, W, 3] images, numpy or a tensor on any device
        (moved to the step's) -> :meth:`detect`'s result on the device."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(self.priors.device, non_blocking=True)
        return self.detect(*self.forward(images))


def dropped(dense: Tensor, rows: Tensor) -> Tensor:
    """int32 [B]: per-class survivors in ``dense`` [B, C, K, 5] that the
    cross-class ``rows`` [B, R, 6] do not keep."""
    n_dense = (dense[..., 0] > 0).sum((1, 2), dtype=torch.int32)
    n_kept = (rows[..., 0] > 0).sum(1, dtype=torch.int32)
    return n_dense - n_kept


def make_eval_step(model, priors: Tensor, cfg, compact=None) -> EvalStep:
    """The eval step for ``model`` (a detector of ``cfg``'s family, in
    either mode: it runs in eval mode) and ``priors`` (on the device the
    step runs on); ``compact`` as ``odtpu``'s (default
    ``EVAL.COMPACT``)."""
    return EvalStep(model, priors, cfg, compact)
