"""The debug entry: build everything, take ONE train step and run one eval
pass, with input-gradient saliency under ``LOG.SHOW_SALIENCY``.

Counterpart of root ``train_debug.py`` (the reference's train_debug.py:
train.py with an immediate return after the first eval)::

    python -m odtpu_torch.train_debug --cfg_name ssd_vgg16_voc
        [--job_group base] [--cfg YML] [--output_dir debug_eval_out]
        [--device cuda]

It builds the model, its train state and the train and eval steps,
takes one train step on the train loader's first batch and prints its
``loss``, ``loc``, ``conf`` and ``npos``. Under ``LOG.SHOW_SALIENCY`` it
writes ``utils.visualize.viz_grads`` of the eval-mode forward's sources
for the batch's image 0 to TensorBoard under ``<output_dir>/tb`` (a
uint8 device-photometric batch is mean-subtracted and flipped to RGB
first, as ``train_debug.py:71-74`` does). On a card each eval-mode batch
norm's backward runs the kernel's dx entry. Then one eval pass
over the eval loader prints the mAP and the timing. :func:`run` returns
these figures for a caller that edits the cfg first (a dataset directory,
say).
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from .data import dataset_factory
from .eval.evaluator import eval_solver_factory
from .eval_step import make_eval_step
from .train_step import create_train_state, make_train_step
from .utils.config import refuse_mesh, resolve_cfg_args
from .utils.logging import TBWriter
from .utils.visualize import viz_grads


def saliency_input(images: np.ndarray, cfg) -> np.ndarray:
    """Image 0 of a train batch as the network input: [1, H, W, 3] float32
    RGB, mean-subtracted (a uint8 device-photometric batch converted
    here; a float batch already is)."""
    img = images[:1]
    if img.dtype == np.uint8:
        img = (img.astype(np.float32)
               - np.asarray(cfg.DATASET.PIXEL_MEANS, np.float32))
        img = img[..., ::-1]
    return np.ascontiguousarray(img, np.float32)


def source_fn(model):
    """NHWC images -> the eval-mode forward's source feature maps."""
    def sources(x):
        return model(x, phase="eval", return_sources=True)[-1]
    return sources


@contextlib.contextmanager
def input_gradient_mode(model):
    """``model`` in eval mode with its parameters' ``requires_grad`` off,
    both put back after: a gradient taken inside is with respect to the
    input alone, as ``jax.grad`` of the image gives it, and no parameter
    gradient is computed."""
    training = model.training
    trainable = [p for p in model.parameters() if p.requires_grad]
    model.eval()
    for p in trainable:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        model.train(training)
        for p in trainable:
            p.requires_grad_(True)


def saliency(model, image, cfg, tb_writer) -> list:
    """``viz_grads`` of ``model``'s eval-mode sources on ``image`` (under
    :func:`input_gradient_mode`); the raw gradients, one a source."""
    with input_gradient_mode(model):
        device = next(model.parameters()).device
        return viz_grads(source_fn(model), torch.from_numpy(image).to(device),
                         cfg.DATASET.PIXEL_MEANS, tb_writer)


def run(cfg, device="cuda", out_dir="debug_eval_out",
        tb_writer=None) -> dict:
    """One train step, saliency under ``LOG.SHOW_SALIENCY`` (to
    ``tb_writer``, else a TBWriter under ``<out_dir>/tb``), one eval pass.
    Returns the step's metrics, the saliency's raw gradients and input
    image (None without the flag), the mAP, the eval timing and the
    train state. One process: a ``cfg`` that asks for a mesh is
    refused."""
    refuse_mesh(cfg, "python -m odtpu_torch.train_debug")
    state, priors = create_train_state(cfg, device)
    step_fn = make_train_step(priors, cfg)
    eval_fn = make_eval_step(state.model, priors, cfg)

    batches = iter(dataset_factory("train", cfg))
    try:
        batch = next(batches)
    finally:
        batches.close()  # stops the loader's threads
    metrics = step_fn(state, torch.from_numpy(batch["images"]),
                      torch.from_numpy(batch["boxes"]),
                      torch.from_numpy(batch["labels"]))
    metrics = {k: float(v) for k, v in metrics.items()}
    print("one step: loss={:.4f} loc={:.4f} conf={:.4f} npos={}".format(
        metrics["loss"], metrics["loss_loc"], metrics["loss_conf"],
        int(metrics["num_pos"])), flush=True)

    grads = image = None
    if cfg.LOG.SHOW_SALIENCY:
        # input-gradient saliency per source map (reference
        # visualize_utils.py:152-202 viz_module_grads)
        tb = tb_writer or TBWriter(os.path.join(out_dir, "tb"))
        image = saliency_input(batch["images"], cfg)
        try:
            grads = saliency(state.model, image, cfg, tb)
        finally:
            if tb_writer is None:
                tb.close()
        print("saliency maps of {} sources written to {}".format(
            len(grads), os.path.join(out_dir, "tb")), flush=True)

    solver = eval_solver_factory(dataset_factory("eval", cfg), cfg, out_dir)
    _, maps = solver.validate(eval_fn)
    print("eval ok: mAP", maps, "timing", solver.last_timing, flush=True)
    return {"metrics": metrics, "grads": grads, "image": image,
            "maps": maps, "timing": solver.last_timing, "state": state}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="odtpu_torch debug entry: one "
                                "train step and one eval pass")
    p.add_argument("--cfg_name", default="")
    p.add_argument("--job_group", default="")
    p.add_argument("--cfg", default="")
    p.add_argument("--output_dir", default="debug_eval_out")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    cfg = resolve_cfg_args(args)
    os.makedirs(args.output_dir, exist_ok=True)
    return run(cfg, args.device, args.output_dir)


if __name__ == "__main__":
    main()
