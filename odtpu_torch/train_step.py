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
  (``models.common.recomputing``). The recompute runs whole (the
  checkpoint's early stop is off) and first: the first node of the
  region's backward (:class:`_RecomputeFirst`) unpacks a saved tensor,
  which runs the recompute before any other node of the region.

On a mesh (``parallel``) the step is ``odtpu``'s step on the global
batch, the concatenation of the data indices' batches in order; every
rank of one data index holds the same images:

- the photometric parameters are drawn for the global batch and each
  data index takes its block of rows (:meth:`TrainStep.aug_params`);
- every ``max(num_pos, 1)`` is the global count (the positives summed
  over the data group), so each data index's loss is its share of the
  global loss, and the reported metrics are the global ones on every
  rank;
- the model is laid out on the mesh (``models.shard_model``: the wide
  convs' output channels over the model axis, the images' rows over the
  spatial axis, its outputs whole on every rank), and train-mode batch
  norm takes the global batch's statistics (``models.common.batch_norm``);
- the gradients are summed over the replica group by one all-reduce of
  a flat buffer (:meth:`TrainStep.backward`) before the clip and the
  update, which then run as in one process, the clip's norm counting a
  sharded tensor's blocks once each (:func:`clip_by_global_norm`).
  Hard-negative mining stays per image;
- under ``TPU.REMAT`` the recompute runs every exchange of the forward
  again (the tensor-parallel gathers, the halo fetches and the heads'
  gathers of a plan replayed from its start, the norms' sums over the
  replica group); since it runs whole and first, every rank runs it at
  the same point of the backward, before any backward exchange.

Training covers every family of the zoo.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor, nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from . import parallel, trace
from .data.device_aug import draw_params, preprocess_train_batch
from .layers.losses import multibox_loss, refinedet_loss, repulsion_loss
from .models import compute_dtype, model_factory, shard_model
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
def clip_by_global_norm(params, max_norm: float, sharded=()) -> Tensor:
    """Scale every gradient by ``max_norm / norm`` when the global norm is
    above ``max_norm`` (optax's form: ``g / norm * max``, no epsilon);
    returns the norm. A few multi-tensor kernels, whatever the count of
    tensors; nothing waits for the device. The ``sharded`` parameters
    hold a model rank's block (``parallel.sharded_params``): their
    squares are summed over the model group, the replicated ones counted
    once."""
    grads = [p.grad for p in params if p.grad is not None]
    if sharded:
        ids = {id(p) for p in sharded}
        blocks = [p.grad for p in params if id(p) in ids]
        whole = [p.grad for p in params
                 if p.grad is not None and id(p) not in ids]
        sq = parallel.axis_sum(torch.stack(torch._foreach_norm(
            blocks)).square().sum(), "model")
        sq = sq + torch.stack(torch._foreach_norm(whole)).square().sum()
        norm = torch.sqrt(sq)
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
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
    """(TrainState with seeded weights on ``device``, priors [P, 4]); on
    a mesh the model is laid out on it (``models.shard_model``) before
    the optimizer takes its parameters, so that each momentum follows
    its parameter's layout."""
    model, priors, _ = model_factory("train", cfg, device, seed)
    shard_model(model, cfg)
    model.train()
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState(model, make_optimizer(model.parameters(), cfg)), priors


class _RecomputeFirst(torch.autograd.Function):
    """The identity on a checkpointed forward's outputs, whose backward
    unpacks a tensor saved inside the checkpoint: the recompute runs
    there, before the backward of any other node of the region (each
    one's gradient flows from this node's), at the same point on every
    rank."""

    @staticmethod
    def forward(ctx, *outputs):
        ctx.save_for_backward(outputs[0])
        return tuple(o.view_as(o) for o in outputs)

    @staticmethod
    def backward(ctx, *grads):
        _ = ctx.saved_tensors  # the unpack runs the recompute
        return grads


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
        # in a process group: the ranks' collectives (identities at world 1)
        self.sync = parallel.initialized()

    def aug_params(self, batch: int, step: int) -> dict:
        """The photometric parameters of update ``step`` for this data
        index's ``batch`` images: drawn for the global batch from a
        generator on the device seeded by (17, step), and this data
        index's rows of them."""
        g = torch.Generator(device=self.device)
        g.manual_seed((17 << 32) + int(step))
        return parallel.local_rows(
            draw_params(batch * parallel.data_world(), g), batch)

    @trace.spanned("train.augment")
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

    @trace.spanned("train.forward")
    def forward(self, state: TrainState, images: Tensor) -> tuple:
        """The model's raw outputs: (loc, conf), RefineDet's (arm_loc,
        arm_conf, odm_loc, odm_conf). Under ``TPU.REMAT`` the backward
        runs the forward again, whole and first, inside
        :func:`recomputing` (see the module's docstring)."""
        if not self.remat:
            return state.model(images, phase="train")
        calls = []

        def run(x):
            with recomputing() if calls else contextlib.nullcontext():
                calls.append(None)
                return _RecomputeFirst.apply(*state.model(x, phase="train"))

        # the early stop is read when the checkpoint's forward runs
        with set_checkpoint_early_stop(False):
            return checkpoint(run, images, use_reentrant=False)

    @trace.spanned("train.loss")
    def loss(self, outputs: tuple, boxes: Tensor, labels: Tensor,
             step: int) -> dict:
        """The metrics of :meth:`forward`'s ``outputs`` at update ``step``
        (the count of updates already made). On a mesh the losses are
        this data index's sums over the global counts, and ``num_pos`` is
        the global count."""
        if self.refinedet:
            r = refinedet_loss(*outputs, self.priors, boxes, labels,
                               self.variances, self.overlap, self.negpos,
                               use_refined=step >= self.odm_warm)
            loss_l = loss_c = 0.0
            for part in r:
                n = torch.clamp(parallel.data_sum(part.num_pos),
                                min=1).float()
                loss_l = loss_l + self.loc_w * part.loss_loc_sum / n
                loss_c = loss_c + part.loss_conf_sum / n
            return {"loss": loss_l + loss_c, "loss_loc": loss_l,
                    "loss_conf": loss_c,
                    "num_pos": parallel.data_sum(r.odm.num_pos)}
        out = multibox_loss(*outputs, self.priors, boxes, labels,
                            self.variances, self.overlap, self.negpos)
        num_pos = parallel.data_sum(out.num_pos)
        n = torch.clamp(num_pos, min=1).float()
        loss_l = out.loss_loc_sum / n
        loss_c = out.loss_conf_sum / n
        metrics = {"loss": self.loc_w * loss_l + loss_c, "loss_loc": loss_l,
                   "loss_conf": loss_c, "num_pos": num_pos}
        if self.rep_w > 0:
            rep_sum, rep_n = repulsion_loss(outputs[0], self.priors, boxes,
                                            labels, self.variances)
            loss_rep = rep_sum / torch.clamp(parallel.data_sum(rep_n),
                                             min=1).float()
            metrics["loss"] = metrics["loss"] + self.rep_w * loss_rep
            metrics["loss_repul"] = loss_rep
        return metrics

    @trace.spanned("train.backward")
    def backward(self, state: TrainState, metrics: dict) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        # a weight the loss does not reach (DRN_SSD's last stages) gets a
        # zero gradient, so that it decays as optax decays it
        params = [p for group in state.optimizer.param_groups
                  for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.sync:
            parallel.all_reduce_grads(params,
                                      parallel.sharded_params(state.model))

    @trace.spanned("train.update")
    def update(self, state: TrainState) -> None:
        if self.clip > 0:
            clip_by_global_norm([p for group in state.optimizer.param_groups
                                 for p in group["params"]], self.clip,
                                parallel.sharded_params(state.model))
        lr = self.sched(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if self.sync:
            parallel.sync_replicated_buffers(state.model)
        state.step += 1

    @trace.spanned("train.step", step=True)
    def __call__(self, state: TrainState, images: Tensor, boxes: Tensor,
                 labels: Tensor, aug_params: dict | None = None) -> dict:
        images = self.augment(images.to(self.device, non_blocking=True),
                              state.step, aug_params)
        outputs = self.forward(state, images)
        # a blocking copy: the host waits for the work queued so far
        with trace.span("train.targets_h2d"):
            boxes, labels = boxes.to(self.device), labels.to(self.device)
        metrics = self.loss(outputs, boxes, labels, state.step)
        self.backward(state, metrics)
        self.update(state)
        return self.report(metrics)

    def report(self, metrics: dict) -> dict:
        """:meth:`loss`'s metrics, detached; on a mesh the losses are
        summed over the data group (each data index's is its share of the
        global loss), so every rank reports the global ones."""
        out = {k: v.detach() for k, v in metrics.items()}
        if self.sync:
            keys = [k for k in out if k != "num_pos"]
            summed = parallel.data_sum(torch.stack([out[k] for k in keys]))
            out.update(zip(keys, summed.unbind()))
        return out


def make_train_step(priors: Tensor, cfg) -> TrainStep:
    """The train step for ``cfg`` and ``priors`` (on the step's device)."""
    return TrainStep(priors, cfg)
