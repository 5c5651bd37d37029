"""The train step: schedule, optimizer, state and one SGD update.

Counterpart of ``odtpu/parallel/train.py`` ``lr_schedule``,
``make_optimizer``, ``create_train_state`` and ``make_train_step`` on one
device:

- the loss is ``(conf + LOC_WEIGHT * loc) / max(num_pos, 1)``, with the
  forward in ``COMPUTE_DTYPE`` and the loss in float32; RefineDet's is
  the sum of its ARM's and its ODM's, each over its own ``max(num_pos,
  1)``, and its ODM matches against the raw anchors for the first
  ``LOSS.ODM_MATCH_WARM_ITERS`` updates;
- the model runs in train mode: every batch norm normalises with the
  batch's statistics and moves its running ones, as flax's
  ``mutable=["batch_stats"]`` apply does (``models.common.batch_norm``);
- the schedule is evaluated at the count of updates already made (0 for
  the first), as optax does, and each step sets its learning rate from
  it: the decay boundaries at or past ``MAX_ITER`` are dropped, and the
  warmup overlays the first steps without shifting them;
- clipping is optax's ``clip_by_global_norm``: ``g / norm * max`` only
  when ``norm > max``, before the weight decay;
- ``add_decayed_weights`` then ``sgd(momentum)`` is ``torch.optim.SGD``
  with ``weight_decay`` and ``momentum`` over every parameter in one
  group (biases, the L2Norm scales and the batch norms' scale and bias
  decay too; their running statistics are buffers, not decayed); Adam
  likewise. Momentum starts at zero in both packages;
- the photometric distortion of a uint8 batch draws from a generator
  seeded by (17, step), as ``odtpu`` folds the step into ``PRNGKey(17)``,
  so a resumed run draws what an unbroken run draws.

- ``LOSS.REPULSION_WEIGHT`` > 0 adds ``w * rep_sum / max(rep_n, 1)``
  (RepGT, ``layers.losses.repulsion_loss``) outside RefineDet, reported
  as ``loss_repul``, as ``odtpu/parallel/train.py:189-196`` does;
- ``TPU.REMAT`` checkpoints the whole model forward
  (``torch.utils.checkpoint``, non-reentrant), as ``odtpu`` wraps its
  apply in ``jax.checkpoint``: the backward recomputes it. The running
  statistics move once, in the first forward
  (``models.common.recomputing``).

Training covers every family of the zoo.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor, nn
from torch.utils.checkpoint import checkpoint

from .data.device_aug import draw_params, preprocess_train_batch
from .layers.losses import multibox_loss, refinedet_loss, repulsion_loss
from .models import compute_dtype, model_factory
from .models.common import recomputing


def lr_schedule(cfg):
    """step -> learning rate (a float32 value, as optax computes it)."""
    sch = cfg.TRAIN.LR_SCHEDULER
    base = np.float32(cfg.TRAIN.OPTIMIZER.LR)
    boundaries = sorted((int(s), np.float32(sch.GAMMA)) for s in sch.STEPS
                        if int(s) < int(cfg.TRAIN.MAX_ITER))
    warm = int(sch.WARMUP_ITERS)

    def sched(step: int) -> float:
        step = int(step)
        if step < warm:
            frac = np.float32(step) / np.float32(warm)
            return float(base * (np.float32(0.1) + np.float32(0.9) * frac))
        lr = base
        for boundary, gamma in boundaries:
            if step >= boundary:
                lr = gamma * lr
        return float(lr)

    return sched


def make_optimizer(params, cfg) -> torch.optim.Optimizer:
    """SGD with momentum, or Adam, with weight decay added to the
    gradient; the learning rate is set by the step from the schedule."""
    opt = cfg.TRAIN.OPTIMIZER
    name = str(opt.OPTIMIZER).lower()
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=float(opt.LR),
                               momentum=float(opt.MOMENTUM),
                               weight_decay=float(opt.WEIGHT_DECAY))
    if name == "adam":
        return torch.optim.Adam(params, lr=float(opt.LR),
                                weight_decay=float(opt.WEIGHT_DECAY))
    raise KeyError("unknown optimizer {!r}".format(name))


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> Tensor:
    """Scale every gradient by ``max_norm / norm`` when the global norm is
    above ``max_norm`` (optax's form: ``g / norm * max``, no epsilon);
    returns the norm. A few multi-tensor kernels, whatever the count of
    tensors; nothing waits for the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    # x / 1 * 1 is x: the gradients are left as they are when kept
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


@dataclass
class TrainState:
    """What a checkpoint holds: the model, its optimizer and the count of
    updates made."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(cfg, device="cuda", seed: int = 0):
    """(TrainState with seeded weights on ``device``, priors [P, 4])."""
    model, priors, _ = model_factory("train", cfg, device, seed)
    model.train()
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState(model, make_optimizer(model.parameters(), cfg)), priors


class TrainStep:
    """``step(state, images, boxes, labels) -> metrics``: one update of
    ``state`` in place.

    ``images`` is a uint8 BGR [B, H, W, 3] batch when
    ``DATASET.DEVICE_PHOTOMETRIC`` is on (distorted, mean-subtracted and
    flipped to RGB here), else the host's float32 RGB mean-subtracted
    batch. ``boxes`` [B, G, 4] and ``labels`` [B, G] (< 0 pads). The
    metrics are tensors on the device: nothing here waits for it.

    The stages (:meth:`augment`, :meth:`forward`, :meth:`loss`,
    :meth:`backward`, :meth:`update`) are public so a caller can time
    them one by one; ``__call__`` runs them in that order.
    """

    def __init__(self, priors: Tensor, cfg):
        self.priors = priors
        self.device = priors.device
        self.variances = tuple(float(v) for v in cfg.MODEL.VARIANCE)
        self.overlap = float(cfg.LOSS.OVERLAP_THRESH)
        self.negpos = int(cfg.LOSS.NEG_POS_RATIO)
        self.loc_w = float(cfg.LOSS.LOC_WEIGHT)
        self.rep_w = float(cfg.LOSS.REPULSION_WEIGHT)
        self.remat = bool(cfg.TPU.REMAT)
        self.refinedet = cfg.MODEL.SSD_TYPE == "RefineDet"
        self.odm_warm = int(cfg.LOSS.ODM_MATCH_WARM_ITERS)
        self.device_photo = bool(cfg.DATASET.DEVICE_PHOTOMETRIC)
        self.distort = bool(cfg.DATASET.PHOTOMETRIC)
        self.means = tuple(float(m) for m in cfg.DATASET.PIXEL_MEANS)
        # the distortion in float32, or float64 for a float64 step
        self.input_dtype = torch.promote_types(compute_dtype(cfg),
                                               torch.float32)
        self.clip = float(cfg.TRAIN.OPTIMIZER.CLIP_GRAD_NORM or 0.0)
        self.sched = lr_schedule(cfg)

    def aug_params(self, batch: int, step: int) -> dict:
        """The photometric parameters of update ``step``, from a generator
        on the device seeded by (17, step)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((17 << 32) + int(step))
        return draw_params(batch, g)

    def augment(self, images: Tensor, step: int,
                aug_params: dict | None = None) -> Tensor:
        if not self.device_photo:
            if images.dtype == torch.uint8:
                raise TypeError(
                    "a uint8 batch needs DATASET.DEVICE_PHOTOMETRIC; "
                    "otherwise the host sends normalized float32 RGB")
            return images
        if self.distort and aug_params is None:
            aug_params = self.aug_params(images.shape[0], step)
        return preprocess_train_batch(images, aug_params, self.means,
                                      self.distort, self.input_dtype)

    def forward(self, state: TrainState, images: Tensor) -> tuple:
        """The model's raw outputs: (loc, conf), RefineDet's (arm_loc,
        arm_conf, odm_loc, odm_conf). Under ``TPU.REMAT`` the backward
        runs the forward again, inside :func:`recomputing`."""
        if not self.remat:
            return state.model(images, phase="train")
        calls = []

        def run(x):
            with recomputing() if calls else contextlib.nullcontext():
                calls.append(None)
                return state.model(x, phase="train")

        return checkpoint(run, images, use_reentrant=False)

    def loss(self, outputs: tuple, boxes: Tensor, labels: Tensor,
             step: int) -> dict:
        """The metrics of :meth:`forward`'s ``outputs`` at update ``step``
        (the count of updates already made)."""
        if self.refinedet:
            r = refinedet_loss(*outputs, self.priors, boxes, labels,
                               self.variances, self.overlap, self.negpos,
                               use_refined=step >= self.odm_warm)
            loss_l = loss_c = 0.0
            for part in r:
                n = torch.clamp(part.num_pos, min=1).float()
                loss_l = loss_l + self.loc_w * part.loss_loc_sum / n
                loss_c = loss_c + part.loss_conf_sum / n
            return {"loss": loss_l + loss_c, "loss_loc": loss_l,
                    "loss_conf": loss_c, "num_pos": r.odm.num_pos}
        out = multibox_loss(*outputs, self.priors, boxes, labels,
                            self.variances, self.overlap, self.negpos)
        n = torch.clamp(out.num_pos, min=1).float()
        loss_l = out.loss_loc_sum / n
        loss_c = out.loss_conf_sum / n
        metrics = {"loss": self.loc_w * loss_l + loss_c, "loss_loc": loss_l,
                   "loss_conf": loss_c, "num_pos": out.num_pos}
        if self.rep_w > 0:
            rep_sum, rep_n = repulsion_loss(outputs[0], self.priors, boxes,
                                            labels, self.variances)
            loss_rep = rep_sum / torch.clamp(rep_n, min=1).float()
            metrics["loss"] = metrics["loss"] + self.rep_w * loss_rep
            metrics["loss_repul"] = loss_rep
        return metrics

    def backward(self, state: TrainState, metrics: dict) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        # a weight the loss does not reach (DRN_SSD's last stages) gets a
        # zero gradient, so that it decays as optax decays it
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)

    def update(self, state: TrainState) -> None:
        if self.clip > 0:
            clip_by_global_norm([p for group in state.optimizer.param_groups
                                 for p in group["params"]], self.clip)
        lr = self.sched(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1

    def __call__(self, state: TrainState, images: Tensor, boxes: Tensor,
                 labels: Tensor, aug_params: dict | None = None) -> dict:
        images = self.augment(images.to(self.device, non_blocking=True),
                              state.step, aug_params)
        metrics = self.loss(self.forward(state, images),
                            boxes.to(self.device), labels.to(self.device),
                            state.step)
        self.backward(state, metrics)
        self.update(state)
        return {k: v.detach() for k, v in metrics.items()}


def make_train_step(priors: Tensor, cfg) -> TrainStep:
    """The train step for ``cfg`` and ``priors`` (on the step's device)."""
    return TrainStep(priors, cfg)
