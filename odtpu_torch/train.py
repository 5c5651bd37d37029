"""The train loop: steps, logs, checkpoints, resume and validation.

Counterpart of the loop in ``train.py:240-333``: the train step over the
loader until ``TRAIN.MAX_ITER``; the loss and images/s every
``LOG_LOSS_ITER`` steps, read from the step before, so that each read
waits for that step and the images/s window is measured on the device's
clock; a checkpoint every ``SAVE_ITER`` steps and at the end; a
validation every ``EVAL_ITER`` steps and at the end, through the serving
path's eval step (the CUDA NMS kernel on a card), which runs the model in
eval mode and hands it back in train mode: batch norm validates with its
running statistics and leaves them as they are. Saves and validations
restart the throughput window. Resume and auto-resume read
``<out_dir>/ckpt``.

The command line (``main(argv)``) comes with the data slice, as do
TensorBoard, the profiler trace and the multi-host options.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from .eval_step import make_eval_step
from .train_step import create_train_state, make_train_step
from .utils.checkpoint import Checkpointer, load_basenet


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(cfg, train_loader, eval_solver, out_dir, device="cuda", seed=0,
        resume="", auto_resume=False, basenet="") -> dict:
    """Train from seeded weights (or ``basenet``, or a checkpoint) to
    ``cfg.TRAIN.MAX_ITER``.

    ``train_loader`` yields dict batches (``images``, ``boxes``,
    ``labels``: see ``odtpu_torch.data.loader.DetLoader``);
    ``eval_solver`` is an ``odtpu_torch.eval.evaluator.EvalVOC``. Returns
    the final step, the logged losses, each validation's step, mAP and
    dropped count, the checkpoint steps on disk and the
    :class:`~odtpu_torch.train_step.TrainState`.
    """
    device = torch.device(device)
    out_dir = Path(out_dir)
    ckpt = Checkpointer(out_dir / "ckpt")
    if auto_resume and not resume and ckpt.latest_step() is not None:
        resume = str(ckpt.directory)
        print("auto-resume: checkpoint found under", resume, flush=True)

    state, priors = create_train_state(cfg, device, seed)
    if basenet:
        scheme, loaded, skipped = load_basenet(state.model, basenet)
        print("basenet import ({}): {} loaded, {} skipped".format(
            scheme, len(loaded), len(skipped)), flush=True)
    if resume:
        Checkpointer(resume).restore(state)
        print("resumed at step", state.step, flush=True)
    step_fn = make_train_step(priors, cfg)
    eval_fn = make_eval_step(state.model, priors, cfg)

    max_iter = int(cfg.TRAIN.MAX_ITER)
    log_every = int(cfg.TRAIN.LOG_LOSS_ITER)
    save_every = int(cfg.TRAIN.SAVE_ITER)
    eval_every = int(cfg.TRAIN.EVAL_ITER)
    if len(train_loader) == 0:
        raise ValueError("the train loader yields no batch")
    out = {"losses": [], "evals": []}

    start = it = state.step
    last_log_iter, last_log_time = it, time.time()
    pending = None  # (step, metrics) not read yet
    while it < max_iter:
        for batch in train_loader:
            if it >= max_iter:
                break
            metrics = step_fn(state, torch.from_numpy(batch["images"]),
                              torch.from_numpy(batch["boxes"]),
                              torch.from_numpy(batch["labels"]))
            it = state.step
            if it == start + 1:
                # the first window starts after the first step's set-up
                _sync(device)
                last_log_iter, last_log_time = it, time.time()
            if pending is not None and pending[0] % log_every == 0:
                m = {k: float(v) for k, v in pending[1].items()}
                now = time.time()
                ips = ((pending[0] - last_log_iter)
                       * batch["images"].shape[0]
                       / max(now - last_log_time, 1e-9))
                last_log_iter, last_log_time = pending[0], now
                out["losses"].append({"step": pending[0], **m, "ips": ips})
                print("iter {} | loss {:.4f} (loc {:.4f} conf {:.4f}) | "
                      "{:.1f} img/s".format(pending[0], m["loss"],
                                            m["loss_loc"], m["loss_conf"],
                                            ips), flush=True)
            pending = (it, metrics)

            if it % save_every == 0 or it == max_iter:
                ckpt.save(it, state)
                print("saved checkpoint at", it, flush=True)
                last_log_iter, last_log_time = it, time.time()
            if it % eval_every == 0 or it == max_iter:
                _, maps = eval_solver.validate(eval_fn)
                dropped = eval_solver.last_timing["dropped_dets"]
                out["evals"].append({"step": it, "mAP": maps[0],
                                     "dropped": dropped})
                print("iter {} | mAP {}".format(it, maps), flush=True)
                last_log_iter, last_log_time = it, time.time()

    ckpt.save(max_iter, state, force=True)
    out.update(step=it, state=state, ckpt_steps=ckpt.all_steps())
    print("done at iter", it, flush=True)
    return out
