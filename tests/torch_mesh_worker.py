"""One rank of tests/test_torch_mesh.py's mesh runs (not a test file; it
imports no JAX).

    RANK=r WORLD_SIZE=w MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_mesh_worker.py WORK DxMxS

joins a gloo group on the CPU, lays out the ``(D, M, S)`` mesh
(``parallel.make_mesh``) with the tensor-parallel threshold lowered to 64
channels, and for each step case of ``WORK/job.json`` (each case's
float64 weights and global batch in ``WORK/<case>.pt``, written by the
test):

- takes one float64 train step on the batch (the photometric parameters
  given), and writes the metrics and the full parameters, momenta and
  buffers after it (gathered over the model group);
- runs the eval step on the batch's images from the weights before the
  step: the gathered loc and conf, and the rows;
- takes the same step again from the same weights under ``TPU.REMAT``
  (a state of its own), and writes the same, with the halo bytes rank 0
  sent by pass (forward, recompute, backward) in each of the two steps;
- at 1x2x1: serves the batch in int8 (``TPU.QUANT``) in float32 from the
  float32 weights: the gathered loc and conf, and the rows;
- at 1x2x1, for the case named ``resume``: saves the state after the
  step (``Checkpointer``: the blocks gathered, full tensors written),
  then takes a second step on the same batch, uninterrupted;
- at 1x1x2, when the job names a ``resume`` case: once that checkpoint
  is on disk, restores it at this layout and takes the second step;
- at 1x2x2, when the job holds the ``fssd`` case: takes its step again
  with the outputs of ``transform_0`` (before the fusion norm) and
  ``pyramid_0`` (before the heads) off by (m + 1) * 1e-6 on model rank
  m, as a card's non-deterministic kernels leave the model ranks'
  replicated activations, and gathers every rank's digests of its
  replicated parameters, momenta and running statistics.

Rank 0 writes ``WORK/<DxMxS>.pt``. The states are built without their
seeded init: every case loads its weights over it.
"""

import datetime
import os
import sys
import time

import torch
import torch.distributed as dist

from odtpu_torch import models, parallel
from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.models import fssd
from odtpu_torch.parallel import spatial
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils.checkpoint import Checkpointer

import torch_parallel_worker as pw

torch.set_num_threads(1)

# the narrow models' widths reach 64 to 128 channels: shard them all
TP_MIN_CHANNELS = 64
WAIT = 120.0  # seconds the 1x1x2 ranks wait for the checkpoint


def layout_of(text):
    return tuple(int(v) for v in text.split("x"))


def mesh_cfg(case, layout):
    """tests/torch_parallel_worker.py's float64 step config on ``layout``."""
    cfg = pw.step_cfg(case)
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL, cfg.TPU.MESH_SPATIAL = layout
    return cfg


def sharded_state(case, layout, weights, remat=False, quant=""):
    """A train state of ``case`` on the current mesh holding the full
    ``weights`` (each rank its blocks), and its step: float64, under
    ``TPU.REMAT`` with ``remat``; float32 with ``quant`` (serving)."""
    cfg = mesh_cfg(case, layout)
    cfg.TPU.REMAT = remat
    if quant:
        cfg.TPU.COMPUTE_DTYPE, cfg.TPU.QUANT = "float32", quant
    state, priors = create_train_state(cfg, "cpu")
    dtype = torch.float32 if quant else torch.float64
    state.model.to(dtype)
    state.model.load_state_dict(parallel.block_state_dict(state.model, {
        k: v.to(dtype) if v.is_floating_point() else v
        for k, v in weights.items()}))
    priors = priors.to(dtype)
    return state, make_train_step(priors, cfg), priors, cfg


def counted_step(state, step, data):
    """:func:`full_result` of one step, with the halo bytes this rank
    sent in it by pass (``parallel.spatial.SENT``)."""
    before = dict(spatial.SENT)
    out = full_result(step_on(state, step, data), state)
    out["sent"] = {k: v - before[k] for k, v in spatial.SENT.items()}
    return out


def eval_result(state, priors, cfg, images):
    """The eval step's gathered outputs and rows."""
    ev = make_eval_step(state.model, priors, cfg)
    outputs = ev.forward(images)
    return {"outputs": [o.clone() for o in outputs],
            "rows": ev.detect(*outputs)["rows"].clone()}


def full_result(metrics, state):
    """The metrics, and copies of the full parameters, momenta and
    buffers."""
    model, opt = state.model, state.optimizer
    full = parallel.full_state_dict(model)
    moms = parallel.full_optimizer_state(model, opt)["state"]
    names = [k for k, _ in model.named_parameters()]
    return {"metrics": {k: v.double() for k, v in metrics.items()},
            "params": {k: full[k].clone() for k in names},
            "momentum": {names[i]: s["momentum_buffer"].clone()
                         for i, s in moms.items()},
            "buffers": {k: full[k].clone()
                        for k, _ in model.named_buffers()}}


def step_on(state, step, data):
    return step(state, data["images"], data["boxes"], data["labels"],
                aug_params=data["draws"])


def replicated_digests(state):
    """sha256 of each replicated parameter, its momentum and each
    replicated floating buffer of this rank's state."""
    model, opt = state.model, state.optimizer
    keys = parallel.tp_keys(model)
    out = {}
    for k, p in model.named_parameters():
        if k not in keys:
            out[k] = pw.digest(p)
            out[k + " momentum"] = pw.digest(opt.state[p]["momentum_buffer"])
    for k, b in model.named_buffers():
        if k not in keys and b.is_floating_point():
            out[k] = pw.digest(b)
    return out


def perturbed_step(case, layout, data):
    """One step of ``case`` whose ``transform_0`` and ``pyramid_0``
    outputs are off by (m + 1) * 1e-6 on model rank m: every rank's
    :func:`replicated_digests`, and this rank's fusion norm's running
    mean."""
    state, step, _, _ = sharded_state(case, layout, data["weights"])
    off = (parallel.current().m + 1) * 1e-6
    for name in ("transform_0", "pyramid_0"):
        getattr(state.model, name).register_forward_hook(
            lambda mod, args, out: out + off)
    step_on(state, step, data)
    digests = [None] * parallel.world()
    dist.all_gather_object(digests, replicated_digests(state))
    return {"digests": digests,
            "running_mean": state.model.fusion_bn.running_mean.clone()}


def main(work, text):
    parallel.init_distributed("cpu", timeout=datetime.timedelta(seconds=150))
    parallel.mesh.TP_MIN_CHANNELS = TP_MIN_CHANNELS
    fssd.FSSD300_PYRAMID = pw.TINY_PYRAMID
    models.init_weights = lambda model, seed: None
    layout = layout_of(text)
    job = torch.load(os.path.join(work, "job.pt"), weights_only=False)
    parallel.make_mesh(mesh_cfg(job["cases"][0], layout))
    out = {"layout": layout, "mesh": parallel.current()}
    for case in job["cases"]:
        data = torch.load(os.path.join(work, case + ".pt"),
                          weights_only=True)
        state, step, priors, cfg = sharded_state(case, layout,
                                                 data["weights"])
        res = {"eval": eval_result(state, priors, cfg, data["images"]),
               "step": counted_step(state, step, data)}
        if case == job["resume"] and layout == (1, 2, 1):
            ckpt = Checkpointer(os.path.join(work, "ckpt"))
            ckpt.save(state.step, state)
            if parallel.is_main():
                open(os.path.join(work, "ckpt_done"), "w").close()
            res["next"] = full_result(step_on(state, step, data), state)
        state, step, _, _ = sharded_state(case, layout, data["weights"],
                                          remat=True)
        res["remat"] = counted_step(state, step, data)
        if layout == (1, 2, 1):
            state, _, priors, cfg = sharded_state(
                case, layout, data["weights"], quant="int8")
            res["int8"] = eval_result(state, priors, cfg, data["images"])
        out[case] = res
    if layout == (1, 2, 2) and "fssd" in job["cases"]:
        data = torch.load(os.path.join(work, "fssd.pt"), weights_only=True)
        out["perturbed"] = perturbed_step("fssd", layout, data)
    if layout == (1, 1, 2) and job["resume"]:
        done, t0 = os.path.join(work, "ckpt_done"), time.time()
        while not os.path.exists(done):
            if time.time() - t0 > WAIT:
                raise TimeoutError("no checkpoint after {} s".format(WAIT))
            time.sleep(0.05)
        case = job["resume"]
        data = torch.load(os.path.join(work, case + ".pt"),
                          weights_only=True)
        state, step, _, _ = sharded_state(case, layout, data["weights"])
        Checkpointer(os.path.join(work, "ckpt")).restore(state)
        out["resumed"] = full_result(step_on(state, step, data), state)
    if parallel.is_main():
        torch.save(out, os.path.join(work, text + ".pt"))
    parallel.barrier()
    parallel.shutdown()
    print("rank done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
