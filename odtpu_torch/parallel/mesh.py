"""Data parallelism across processes: one process a card, launched by
``python -m torch.distributed.run``.

Counterpart of ``odtpu/parallel/mesh.py``'s data axis. ``odtpu`` runs one
jitted step over a mesh whose batch is sharded on "data"; under GSPMD
every sum inside that step covers the *global* batch. The port keeps
that semantics by hand, one process a rank:

- the global batch is the concatenation of the ranks' local batches in
  rank order (``odtpu``'s ``make_array_from_process_local_data``, the
  ``shard_batch`` of a multi-host run): rank r holds rows
  ``[r * b, (r + 1) * b)`` (:func:`local_rows`);
- the parameters are replicated: rank 0's are broadcast once, after the
  train state is made or restored (:func:`broadcast_state`, the
  counterpart of ``shard_params`` at ``MESH_MODEL = 1``);
- what ``odtpu`` sums over the batch is summed over the ranks: the
  positives that normalise the loss (``train_step.TrainStep.loss``),
  the batch-norm statistics, with their gradients
  (``models.common.batch_norm``, :func:`all_reduce_sum`), and the
  gradients (:func:`all_reduce_grads`).

``TPU.MESH_MODEL`` and ``TPU.MESH_SPATIAL`` (tensor-parallel and
H-sharded meshes) are refused (``utils.config.check_mesh``). Without a
process group every function here is the one-process case: world 1,
rank 0, and no collective.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import Tensor

from ..utils.config import check_mesh

# a collective that one rank never reaches fails after this, not never
TIMEOUT = datetime.timedelta(minutes=10)

# what torchrun sets for each process (LOCAL_RANK defaults to 0)
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialized() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0, which writes checkpoints, logs and files for the run."""
    return rank() == 0


def init_distributed(device="cuda", backend: str | None = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes in
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``; returns this rank's device.

    ``device`` "cuda" means ``cuda:LOCAL_RANK``, one card a process; a
    device with an index is kept (ranks that share one card). A CUDA
    device becomes the current one. The backend is NCCL for CUDA and
    gloo for the CPU unless ``backend`` names one (gloo also takes CUDA
    tensors: several ranks on one card, which NCCL refuses).
    """
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            "no {} in the environment: launch with python -m "
            "torch.distributed.run --nproc_per_node N ...".format(
                ", ".join(missing)))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timeout)
    return device


def shutdown() -> None:
    """Leave the process group, if in one."""
    if initialized():
        dist.destroy_process_group()


def collective_device() -> torch.device:
    """Where host data goes for a collective: the current card under
    NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if initialized():
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """The run's data-parallel layout: ``world`` ranks, this one ``rank``,
    its ``device``."""
    world: int
    rank: int
    device: torch.device


def make_mesh(cfg, device="cpu") -> Mesh:
    """The layout of this run, checked against ``cfg.TPU.MESH_*``:
    ``MESH_DATA`` -1 (every process) or the world size; ``MESH_MODEL``
    and ``MESH_SPATIAL`` 1."""
    check_mesh(cfg)
    data = cfg.TPU.MESH_DATA
    if data not in (None, -1) and int(data) != world():
        raise ValueError("TPU.MESH_DATA = {} but the run has {} "
                         "processes".format(data, world()))
    return Mesh(world(), rank(), torch.device(device))


def local_rows(x, batch: int):
    """This rank's rows ``[rank * batch, (rank + 1) * batch)`` of ``x``, a
    tensor, array or dict of them whose leading axis is the global batch
    (``world * batch`` rows)."""
    if isinstance(x, dict):
        return {k: local_rows(v, batch) for k, v in x.items()}
    if x.shape[0] != world() * batch:
        raise ValueError("want {} x {} global rows, got {}".format(
            world(), batch, x.shape[0]))
    return x[rank() * batch:(rank() + 1) * batch]


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum over the ranks of
    the output's gradients: each rank's loss reaches every rank's
    inputs, as under GSPMD."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: Tensor) -> Tensor:
    """``x`` summed over the ranks (a new tensor), differentiable; ``x``
    itself without a process group."""
    return _AllReduceSum.apply(x) if initialized() else x


def global_sum(x: Tensor) -> Tensor:
    """``x`` summed over the ranks, with no gradient (counts, metrics)."""
    x = x.detach()
    if not initialized():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Sum every gradient over the ranks, in place: one all-reduce of one
    flat buffer a dtype. Each rank's loss is its share of the global
    loss (its sums over the global count), so the sum is the gradient of
    the global loss."""
    if not initialized():
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        for g, synced in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(synced.view(g.shape))


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, src: int = 0) -> None:
    """Give every rank rank ``src``'s parameters and buffers (running
    statistics included)."""
    if not initialized():
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src)
