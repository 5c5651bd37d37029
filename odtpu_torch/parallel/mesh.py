"""The process mesh: one process a rank, launched by ``python -m
torch.distributed.run``, on a ``(data, model, spatial)`` layout.

Counterpart of ``odtpu/parallel/mesh.py``. ``odtpu`` runs one jitted
step over a device mesh; under GSPMD every layout computes what the
unsharded step computes. The port keeps that by hand, one process a
rank:

- **the layout** (:func:`make_mesh`): ``W = D * M * S`` ranks, rank r at
  coordinates ``(d, m, s)`` in row-major order, as ``odtpu`` reshapes
  its devices to ``(data, model, spatial)``. ``TPU.MESH_DATA`` -1 takes
  ``W // (M * S)``. Every rank makes the same process groups in the
  same order: the *model* group (same d and s), the *spatial* group
  (same d and m), the *data* group (same m and s) and the *replica*
  group (same m: every d and s);
- **the data axis**: the global batch is the concatenation of the data
  indices' batches in order: data index d holds rows ``[d * b, (d + 1)
  * b)`` (:func:`local_rows`), and every rank of one data index holds
  the same rows. The positives that normalise the loss and the reported
  metrics are summed over the data group (:func:`data_sum`);
- **the model axis** (tensor parallelism): a conv whose output channels
  are at least :data:`TP_MIN_CHANNELS` and divisible by M keeps its
  rank's block of them, with its bias and its batch norm
  (``models.shard_model``). Its input passes :func:`to_model_group`, an
  identity whose backward sums the input gradient's partial sums over
  the model group, and its output :func:`gather_model_group`, an
  all-gather whose backward keeps the rank's block: everything
  downstream is replicated and identical on the model ranks;
- **the spatial axis** (``parallel.spatial``): every map is split along
  H, rows fetched from the neighbours where an op needs them;
- **the gradients** are summed over the replica group
  (:func:`all_reduce_grads`): the data indices' shares of the global
  loss, and the spatial ranks' rows. A replicated parameter's gradient
  and the replicated norms' running statistics are computed on every
  model rank from activations that agree up to rounding: the ones at
  ``m = 0`` are broadcast over the model group each step
  (:func:`sync_replicated_buffers`), so that the copies stay one value;
- **the state**: after the state is made or restored, the blocks of rank
  ``(0, m, 0)`` are broadcast over its replica group, and the
  replicated tensors of rank 0 over the world (:func:`broadcast_state`).

Without a process group every function here is the one-process case:
world 1, rank 0, and no collective. In a process group without
:func:`make_mesh` the layout is data parallelism over every rank.

Gloo takes CUDA tensors for all-reduce and broadcast only: its
all-gathers and point-to-point sends stage CUDA tensors through the
host (:func:`staged`), so that several ranks can share one card, which
NCCL refuses.
"""

from __future__ import annotations

import contextlib
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

# the narrowest output-channel width a conv is sharded at over the model
# axis (odtpu/parallel/mesh.py:71 _TP_MIN_CHANNELS); tests lower it
TP_MIN_CHANNELS = 512

# the mesh axes and the coordinates that each one's group shares
AXES = ("model", "spatial", "data", "replica")


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
    """Leave the process group, if in one, and forget the mesh."""
    global _MESH
    _MESH = None
    _GROUPS.clear()
    if initialized():
        dist.destroy_process_group()


def collective_device() -> torch.device:
    """Where host data goes for a collective: the current card under
    NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def staging_device(t: Tensor) -> torch.device:
    """Where this backend's all-gathers and sends take ``t``: the host
    for a CUDA tensor under gloo, else ``t``'s device."""
    if t.is_cuda and dist.get_backend() != "nccl":
        return torch.device("cpu")
    return t.device


def staged(t: Tensor) -> Tensor:
    """``t`` on :func:`staging_device`, contiguous."""
    return t.detach().to(staging_device(t)).contiguous()


def barrier() -> None:
    if initialized():
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """The run's layout: ``world`` ranks of ``data * model * spatial``,
    this one ``rank`` at coordinates (:attr:`d`, :attr:`m`, :attr:`s`),
    its ``device``."""
    world: int
    rank: int
    device: torch.device
    data: int = 1
    model: int = 1
    spatial: int = 1

    @property
    def d(self) -> int:
        return self.rank // (self.model * self.spatial)

    @property
    def m(self) -> int:
        return self.rank // self.spatial % self.model

    @property
    def s(self) -> int:
        return self.rank % self.spatial

    def rank_of(self, d: int, m: int, s: int) -> int:
        return (d * self.model + m) * self.spatial + s

    def ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The global ranks of ``rank``'s (default this one's) group on
        ``axis``, in order of the axis' coordinate (for the replica
        group: d, then s)."""
        r = self.rank if rank is None else rank
        d, m, s = (r // (self.model * self.spatial),
                   r // self.spatial % self.model, r % self.spatial)
        if axis == "model":
            return [self.rank_of(d, i, s) for i in range(self.model)]
        if axis == "spatial":
            return [self.rank_of(d, m, i) for i in range(self.spatial)]
        if axis == "data":
            return [self.rank_of(i, m, s) for i in range(self.data)]
        if axis == "replica":
            return [self.rank_of(i, m, j) for i in range(self.data)
                    for j in range(self.spatial)]
        raise KeyError("unknown mesh axis {!r}; known: {}".format(axis,
                                                                  AXES))

    def size(self, axis: str) -> int:
        return len(self.ranks(axis))

    @property
    def sharded(self) -> bool:
        """Whether the model or the images are split over ranks."""
        return self.model > 1 or self.spatial > 1


_MESH: Mesh | None = None
# (axis, ranks) -> process group, for every group of every axis
_GROUPS: dict = {}


def current() -> Mesh:
    """The mesh :func:`make_mesh` made, or data parallelism over every
    rank of the process group (world 1 without one)."""
    if _MESH is not None and _MESH.world == world():
        return _MESH
    return Mesh(world(), rank(), torch.device("cpu"), data=world())


def mesh_sizes(cfg, world_size: int) -> tuple[int, int, int]:
    """(D, M, S) of ``cfg.TPU.MESH_*`` on ``world_size`` ranks; raises
    when they do not make up the world."""
    check_mesh(cfg)

    def size(key):
        v = cfg.TPU[key]
        return 1 if v in (None, -1) else int(v)

    model, spatial = size("MESH_MODEL"), size("MESH_SPATIAL")
    data = cfg.TPU.MESH_DATA
    data = world_size // (model * spatial) if data in (None, -1) \
        else int(data)
    if data * model * spatial != world_size:
        raise ValueError(
            "TPU.MESH_DATA x MESH_MODEL x MESH_SPATIAL = {} x {} x {} but "
            "the run has {} processes".format(data, model, spatial,
                                              world_size))
    return data, model, spatial


def make_mesh(cfg, device="cpu") -> Mesh:
    """The layout of this run from ``cfg.TPU.MESH_*`` (see
    :func:`mesh_sizes`), its process groups made, every rank making
    every group in the same order; it becomes :func:`current`."""
    global _MESH
    data, model, spatial = mesh_sizes(cfg, world())
    mesh = Mesh(world(), rank(), torch.device(device), data, model,
                spatial)
    _GROUPS.clear()
    if mesh.world > 1:
        for axis in AXES:
            made = []
            for r in range(mesh.world):
                ranks = mesh.ranks(axis, r)
                if len(ranks) in (1, mesh.world) or ranks in made:
                    continue
                made.append(ranks)
                _GROUPS[(axis, tuple(ranks))] = dist.new_group(ranks)
        # a first collective on the default group, so that later
        # point-to-point batches may involve a subset of the ranks
        dist.barrier()
    _MESH = mesh
    return mesh


def group(axis: str):
    """(process group, size) of this rank's group on ``axis``: the
    default group (None) where it spans the world."""
    mesh = current()
    ranks = mesh.ranks(axis)
    if len(ranks) in (1, mesh.world):
        return None, len(ranks)
    return _GROUPS[(axis, tuple(ranks))], len(ranks)


def axis_size(axis: str) -> int:
    return current().size(axis)


def data_world() -> int:
    """D: the count of data indices, each loading its slice of the data."""
    return current().data


def data_rank() -> int:
    """d: this rank's data index."""
    return current().d


def is_data_leader() -> bool:
    """Whether this rank hands over its data index's results: the one at
    ``m = 0, s = 0`` (the others of its index hold the same)."""
    mesh = current()
    return mesh.m == 0 and mesh.s == 0


def local_rows(x, batch: int):
    """This data index's rows ``[d * batch, (d + 1) * batch)`` of ``x``,
    a tensor, array or dict of them whose leading axis is the global
    batch (``D * batch`` rows)."""
    if isinstance(x, dict):
        return {k: local_rows(v, batch) for k, v in x.items()}
    d, n = data_rank(), data_world()
    if x.shape[0] != n * batch:
        raise ValueError("want {} x {} global rows, got {}".format(
            n, batch, x.shape[0]))
    return x[d * batch:(d + 1) * batch]


class _AllReduceSum(torch.autograd.Function):
    """The sum over one axis' group, whose gradient is the sum over the
    group of the output's gradients: each rank's share of the loss
    reaches every rank's inputs, as under GSPMD."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group(axis)[0])
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.axis), None


def all_reduce_sum(x: Tensor, axis: str = "replica") -> Tensor:
    """``x`` summed over this rank's group on ``axis`` (a new tensor),
    differentiable; ``x`` itself where the group is this rank alone."""
    return _AllReduceSum.apply(x, axis) if axis_size(axis) > 1 else x


def axis_sum(x: Tensor, axis: str) -> Tensor:
    """``x`` summed over this rank's group on ``axis``, with no gradient."""
    x = x.detach()
    if axis_size(axis) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group(axis)[0])
    return x


def data_sum(x: Tensor) -> Tensor:
    """``x`` summed over the data group, with no gradient (counts and
    metrics: the model and spatial ranks of one data index hold the same
    ones)."""
    return axis_sum(x, "data")


def global_sum(x: Tensor) -> Tensor:
    """``x`` summed over every rank, with no gradient."""
    x = x.detach()
    if not initialized():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def all_gather(x: Tensor, axis: str) -> list[Tensor]:
    """Every rank's ``x`` of this rank's group on ``axis``, in the axis'
    order, on ``x``'s device; the shapes must be equal."""
    pg, n = group(axis)
    if n == 1:
        return [x]
    src = staged(x)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=pg)
    return [p.to(x.device) for p in parts]


class _ToModel(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the model
    group: the input gradient of an output-channel shard of a conv is
    that shard's partial sum."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=group("model")[0])
        return grad


def _channels_last(x: Tensor) -> bool:
    """Whether the NCHW ``x`` is laid out NHWC (and not NCHW as well)."""
    return x.dim() == 4 and not x.is_contiguous() \
        and x.is_contiguous(memory_format=torch.channels_last)


class _GatherModel(torch.autograd.Function):
    """The model ranks' channel blocks concatenated along dim 1, whose
    backward keeps this rank's block. Blocks laid out NHWC are gathered
    so: the map keeps the layout one process's conv leaves it in, and the
    next conv runs the algorithm (and the rounding) it runs there."""

    @staticmethod
    def forward(ctx, x):
        ctx.block = (current().m * x.shape[1], x.shape[1])
        if _channels_last(x):
            parts = all_gather(x.permute(0, 2, 3, 1), "model")
            return torch.cat(parts, 3).permute(0, 3, 1, 2)
        return torch.cat(all_gather(x, "model"), 1)

    @staticmethod
    def backward(ctx, grad):
        start, n = ctx.block
        return grad[:, start:start + n]


def to_model_group(x: Tensor) -> Tensor:
    """The input of a tensor-parallel conv (see :class:`_ToModel`)."""
    return _ToModel.apply(x) if axis_size("model") > 1 else x


def gather_model_group(x: Tensor) -> Tensor:
    """The full output of a tensor-parallel conv from its channel blocks
    (see :class:`_GatherModel`)."""
    return _GatherModel.apply(x) if axis_size("model") > 1 else x


def _flat_apply(tensors, collective) -> None:
    """Run ``collective`` in place on one flat buffer a dtype of
    ``tensors`` and copy the result back into them."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, synced in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(synced.view(t.shape))


def _from_first_model_rank(tensors) -> None:
    """Give ``tensors`` the values of this rank's model group's rank at
    ``m = 0``."""
    mesh = current()
    if mesh.model == 1 or not tensors:
        return
    src = mesh.rank_of(mesh.d, 0, mesh.s)
    pg = group("model")[0]
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src, group=pg))


@torch.no_grad()
def all_reduce_grads(params, sharded=()) -> None:
    """Sum every gradient over the replica group, in place: one
    all-reduce of one flat buffer a dtype. Each data index's loss is its
    share of the global loss (its sums over the global count), and each
    spatial rank's gradient comes from its own rows, so the sum is the
    gradient of the global loss.

    A model rank holds its block of a ``sharded`` parameter's gradient
    and the whole of a replicated one's. Every model rank computes the
    replicated gradients from activations that agree only up to rounding
    (a card's kernels need not be deterministic), so they are summed on
    the ranks at ``m = 0`` only and broadcast from there over each model
    group: every copy of a replicated parameter takes the same update."""
    mesh = current()
    ids = {id(p) for p in sharded}
    blocks = [p.grad for p in params if id(p) in ids]
    whole = [p.grad for p in params if id(p) not in ids]
    pg, n = group("replica")
    if n > 1:
        _flat_apply(blocks + (whole if mesh.m == 0 else []),
                    lambda flat: dist.all_reduce(flat, group=pg))
    _from_first_model_rank(whole)


@torch.no_grad()
def sync_replicated_buffers(model: torch.nn.Module) -> None:
    """Give the replicated floating buffers of ``model`` (the running
    statistics of norms that are not sharded) their values at ``m = 0``
    over each model group: each model rank updates them from activations
    that agree only up to rounding."""
    keys = tp_keys(model)
    _from_first_model_rank([b for k, b in model.named_buffers()
                            if k not in keys and b.is_floating_point()])


@torch.no_grad()
def broadcast_state(model: torch.nn.Module) -> None:
    """Give every rank the parameters and buffers (running statistics
    included) of its replica group's rank at ``d = 0, s = 0`` where it
    holds a block of them, and of rank 0 where they are replicated."""
    if world() == 1:
        return
    keys = tp_keys(model)
    pg, n = group("replica")
    src = current().rank_of(0, current().m, 0)
    for k, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        if k not in keys:
            dist.broadcast(t.data, 0)
        elif n > 1:
            dist.broadcast(t.data, src, group=pg)


# --- the tensors of a tensor-parallel model: blocks and full tensors ---

def tp_keys(model: torch.nn.Module) -> dict:
    """{state-dict key: full size of dim 0} of the tensors that ``model``
    holds a model rank's block of (``models.shard_model``); empty for a
    model that is not sharded."""
    return getattr(model, "tp_keys", {})


def block_of(model: torch.nn.Module, key: str, full: Tensor) -> Tensor:
    """This model rank's block of the full tensor ``full`` of ``key``
    (``full`` itself where ``key`` is replicated)."""
    size = tp_keys(model).get(key)
    if size is None:
        return full
    if full.shape[0] != size:
        raise ValueError("{}: a full tensor has {} rows, got {}".format(
            key, size, full.shape[0]))
    n = size // current().model
    m = current().m
    return full[m * n:(m + 1) * n].clone()


def full_of(model: torch.nn.Module, key: str, block: Tensor) -> Tensor:
    """The full tensor of ``key`` from every model rank's ``block``
    (``block`` itself where ``key`` is replicated). Every rank of the
    model group must call it, for the same keys in the same order."""
    if key not in tp_keys(model):
        return block
    return torch.cat(all_gather(block.contiguous(), "model"), 0)


def full_state_dict(model: torch.nn.Module) -> dict:
    """``model.state_dict()`` with full tensors (gathered over the model
    group: every rank of it must call this)."""
    return {k: full_of(model, k, v) for k, v in model.state_dict().items()}


def block_state_dict(model: torch.nn.Module, state_dict) -> dict:
    """A full state dict cut to this model rank's blocks."""
    return {k: block_of(model, k, v) for k, v in state_dict.items()}


def full_shapes(model: torch.nn.Module) -> dict:
    """{state-dict key: shape of its full tensor}."""
    keys = tp_keys(model)
    return {k: ((keys[k],) + tuple(v.shape[1:])) if k in keys
            else tuple(v.shape)
            for k, v in model.state_dict().items()}


def sharded_params(model: torch.nn.Module) -> list:
    """The parameters of ``model`` that hold a model rank's block."""
    keys = tp_keys(model)
    return [p for k, p in model.named_parameters() if k in keys]


def _momentum_names(model, optimizer) -> dict:
    """{optimizer state index: parameter name} of ``optimizer`` over
    ``model``'s parameters (``state_dict``'s integer ids)."""
    names = {id(p): k for k, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: names[id(p)] for i, p in enumerate(params)}


def full_optimizer_state(model, optimizer) -> dict:
    """``optimizer.state_dict()`` with every sharded parameter's state
    gathered to the full tensor (every rank of the model group calls)."""
    sd = optimizer.state_dict()
    names = _momentum_names(model, optimizer)
    state = {}
    for i, entry in sd["state"].items():
        state[i] = {k: full_of(model, names[i], v)
                    if torch.is_tensor(v) and v.dim() else v
                    for k, v in entry.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def block_optimizer_state(model, optimizer, full: dict) -> dict:
    """A full optimizer state dict cut to this model rank's blocks."""
    names = _momentum_names(model, optimizer)
    state = {}
    for i, entry in full["state"].items():
        state[i] = {k: block_of(model, names[int(i)], v)
                    if torch.is_tensor(v) and v.dim() else v
                    for k, v in entry.items()}
    return {"state": state, "param_groups": full["param_groups"]}


@contextlib.contextmanager
def distributed(args):
    """With ``args.multihost``: join ``torch.distributed.run``'s process
    group (``args.device`` becomes this rank's card), print ``process
    r/w``, and leave the group when the block ends. Without it:
    nothing."""
    if not args.multihost:
        yield
        return
    args.device = str(init_distributed(args.device))
    print("process {}/{}".format(rank(), world()), flush=True)
    try:
        yield
    finally:
        shutdown()
