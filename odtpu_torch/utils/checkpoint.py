"""Carry ``odtpu`` weights across to the port, and the train loop's
checkpoints.

``odtpu`` stores a model as a flat map of '/'-joined param paths
(``odtpu/utils/checkpoint.py:146-164``): ``backbone/conv1_1/conv/kernel``
(HWIO), ``.../conv/bias``, ``extras_i/conv/*``, ``head/{loc,conf}_i/conv/*``
and ``l2norm/scale`` (71 tensors for SSD300). The port's modules carry
the same names with '.' joins, so the map is mechanical: kernels go
HWIO -> OIHW and everything becomes float32. Batch norm is mapped by its
module, ``bn`` or ``fusion_bn`` (an L2Norm's ``scale`` keeps its name):
``<path>/bn/scale`` and ``bias`` are ``.weight`` and ``.bias``, and the
running statistics, which ``odtpu``'s npz exports carry under
``__batch_stats__/<path>/bn/{mean,var}`` (``checkpoint.py:143,170-195``),
are ``running_mean`` and ``running_var``.

:class:`Checkpointer` is the counterpart of ``odtpu``'s orbax
``Checkpointer``: ``torch.save`` of the model, the optimizer and the
step, one file per step under the run's ``ckpt/`` directory, the newest
``max_to_keep`` kept. In a process group rank 0 writes and every rank
waits for it; every rank restores (the train loop then broadcasts the
weights of the ranks at ``d = 0, s = 0``). A tensor-parallel model
(``models.shard_model``) is saved whole: every rank takes part in
gathering its blocks (``parallel.full_state_dict``), and rank 0 writes
full tensors in the same format, so that a checkpoint loads at any
layout; a restore, ``--basenet`` and :func:`load_model_npz` read full
tensors and keep the rank's block (``parallel.block_of``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .. import parallel

BATCH_STATS_PREFIX = "__batch_stats__/"
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "scale"}
_BN_MODULES = ("bn", "fusion_bn")
_BN_LEAVES = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _to_port(key: str, value: np.ndarray):
    """An odtpu '/'-joined param (or ``__batch_stats__/``) path and value
    -> (state-dict key, float32 tensor), or None when it has no
    counterpart."""
    stats = key.startswith(BATCH_STATS_PREFIX)
    if stats:
        key = key[len(BATCH_STATS_PREFIX):]
    *path, leaf = key.split("/")
    if not path or key.startswith("__"):
        return None
    if path[-1] in _BN_MODULES:
        leaves = _BN_STATS if stats else _BN_LEAVES
    else:
        leaves = {} if stats else _LEAVES
    if leaf not in leaves:
        return None
    arr = np.array(value, dtype=np.float32)  # an owned copy
    if leaf == "kernel":
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return ".".join(path + [leaves[leaf]]), torch.from_numpy(
        np.ascontiguousarray(arr))


def to_odtpu_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A torch state dict -> ``odtpu``'s flat npz map (the inverse of
    :func:`from_odtpu_params`): param paths, and the batch-norm running
    statistics under ``__batch_stats__/``, as float32 numpy arrays of
    their own (a later update of the model leaves them as they are)."""
    inverse = {v: k for k, v in _LEAVES.items()}
    bn_inverse = {v: (False, k) for k, v in _BN_LEAVES.items()}
    bn_inverse.update({v: (True, k) for k, v in _BN_STATS.items()})
    out = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = np.array(value.detach().cpu().float())  # an owned copy
        if path and path[-1] in _BN_MODULES:
            stats, leaf = bn_inverse[leaf]
        else:
            stats, leaf = False, inverse[leaf]
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        prefix = BATCH_STATS_PREFIX if stats else ""
        out[prefix + "/".join(path + [leaf])] = np.ascontiguousarray(arr)
    return out


def from_odtpu_params(flat: Mapping[str, np.ndarray],
                      model: nn.Module | None = None) -> dict:
    """odtpu param paths (and ``__batch_stats__/`` running statistics) ->
    a torch state dict.

    Strict: a key this port has no place for raises, and, when ``model``
    is given, so does any of its tensors left without a value or given
    one of the wrong shape (batch norm's step counter, which ``odtpu``
    has not, excepted).
    """
    out, unused = {}, []
    for key, value in flat.items():
        mapped = _to_port(key, value)
        if mapped is None:
            unused.append(key)
        else:
            out[mapped[0]] = mapped[1]
    if model is not None:
        want = model.state_dict()
        unused += [k for k in out if k not in want]
        missing = [k for k in want if k not in out
                   and not k.endswith(".num_batches_tracked")]
        wrong = ["{} {} != {}".format(k, tuple(out[k].shape),
                                      tuple(want[k].shape))
                 for k in want if k in out and out[k].shape != want[k].shape]
        if missing or wrong:
            raise KeyError("odtpu params do not cover the model: missing "
                           "{}, wrong shape {}".format(missing, wrong))
    if unused:
        raise KeyError("odtpu params with no place in the port: {}".format(
            sorted(unused)))
    return out


def load_strict(model: nn.Module, state_dict: Mapping) -> None:
    """``model.load_state_dict`` that refuses a missing or unexpected key,
    batch norm's step counter (which ``odtpu`` has not) excepted."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith(".num_batches_tracked")]
    if missing or unexpected:
        raise KeyError("state dict does not fit the model: missing {}, "
                       "unexpected {}".format(missing, unexpected))


def load_odtpu_npz(path, model: nn.Module | None = None) -> dict:
    """A state dict from an ``odtpu`` npz checkpoint (see
    :func:`from_odtpu_params`)."""
    with np.load(path) as data:
        return from_odtpu_params({k: data[k] for k in data.files}, model)


def _merge(model: nn.Module, pairs) -> tuple[list, list]:
    """Load the (npz key, state-dict key, tensor) ``pairs`` whose key and
    full shape match ``model``'s (the rank's block of a tensor-parallel
    one); returns (loaded, skipped) npz keys."""
    want = parallel.full_shapes(model)
    loaded, skipped, sd = [], [], {}
    for npz_key, key, value in pairs:
        if key in want and want[key] == tuple(value.shape):
            sd[key] = parallel.mesh.block_of(model, key, value)
            loaded.append(npz_key)
        else:
            skipped.append(npz_key)
    model.load_state_dict(sd, strict=False)
    return loaded, skipped


def load_model_npz(model: nn.Module, path) -> tuple[list, list]:
    """Partial load of a full-model npz ('/'-joined odtpu param paths) by
    path and shape into ``model``; the rest keeps its init (``odtpu``'s
    ``load_model_npz``). ``__batch_stats__/`` keys are not params and are
    skipped. Returns (loaded, skipped) npz keys."""
    pairs, skipped = [], []
    with np.load(path) as data:
        for k in data.files:
            if k.startswith(BATCH_STATS_PREFIX):
                continue
            mapped = _to_port(k, data[k])
            if mapped is None:
                skipped.append(k)
            else:
                pairs.append((k, *mapped))
    loaded, more = _merge(model, pairs)
    return loaded, skipped + more


def load_backbone_npz(model: nn.Module, path) -> tuple[list, list]:
    """Partial load of converted backbone weights (keys '<conv>/kernel'
    HWIO and '<conv>/bias') into ``model.backbone``; the rest keeps its
    init (``odtpu``'s ``load_backbone_npz``). Returns (loaded, skipped)
    npz keys."""
    pairs, skipped = [], []
    with np.load(path) as data:
        for k in data.files:
            name, _, leaf = k.rpartition("/")
            mapped = _to_port("/".join(["backbone", name, "conv", leaf]),
                              data[k]) if name else None
            if mapped is None:
                skipped.append(k)
            else:
                pairs.append((k, *mapped))
    loaded, more = _merge(model, pairs)
    return loaded, skipped + more


def load_basenet(model: nn.Module, path) -> tuple[str, list, list]:
    """``--basenet``: pick the scheme from the keys (full-model paths have
    three or more segments, backbone keys two), load, and refuse an npz
    that matches nothing (``train.py:151-185``). Returns (scheme, loaded,
    skipped)."""
    with np.load(path) as data:
        keys = list(data.files)
    full_path = sum(len(k.split("/")) >= 3 for k in keys) > len(keys) // 2
    scheme = "full-path" if full_path else "backbone"
    loader = load_model_npz if full_path else load_backbone_npz
    loaded, skipped = loader(model, path)
    if not loaded:
        raise ValueError("--basenet {} matched no parameters (detected {} "
                         "scheme; sample npz keys: {})".format(
                             path, scheme, ", ".join(skipped[:5])))
    return scheme, loaded, skipped


def read_weights(ckpt, model: nn.Module | None = None) -> dict:
    """The state dict that ``ckpt`` names, as the serving entry points
    take it (``odtpu``'s ``restore_eval_variables``): a checkpoint
    directory of ``python -m odtpu_torch.train`` (its latest step) or an
    ``odtpu`` npz (see :func:`load_odtpu_npz`)."""
    if os.path.isdir(ckpt):
        return Checkpointer(ckpt).read()["model"]
    if not os.path.isfile(ckpt):
        raise FileNotFoundError("checkpoint not found: {}".format(ckpt))
    return load_odtpu_npz(ckpt, model)


class Checkpointer:
    """``save(step, state)``, ``latest_step()`` and ``restore(state)`` for
    a :class:`odtpu_torch.train_step.TrainState`, one ``<step>.pt`` file a
    step in ``directory``; the newest ``max_to_keep`` are kept."""

    def __init__(self, directory, max_to_keep: int = 5):
        self.directory = Path(directory).resolve()
        self.max_to_keep = int(max_to_keep)

    def path(self, step: int) -> Path:
        return self.directory / "{}.pt".format(int(step))

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False) -> bool:
        """Write ``state`` as step ``step``; a step already on disk is
        kept unless ``force``. Returns whether it wrote. In a process
        group only rank 0 writes, and every rank returns once it has; a
        tensor-parallel model's blocks are gathered on every rank
        first."""
        payload = None
        if parallel.tp_keys(state.model):
            payload = {"model": parallel.full_state_dict(state.model),
                       "optimizer": parallel.full_optimizer_state(
                           state.model, state.optimizer)}
        wrote = parallel.is_main() and self._write(int(step), state, force,
                                                   payload)
        parallel.barrier()
        return wrote

    def _write(self, step: int, state, force: bool, payload=None) -> bool:
        path = self.path(step)
        if path.is_file() and not force:
            return False
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".pt.{}.tmp".format(os.getpid()))
        payload = payload or {"model": state.model.state_dict(),
                              "optimizer": state.optimizer.state_dict()}
        torch.save({"step": int(state.step), **payload}, tmp)
        os.replace(tmp, path)  # a reader sees the old file or the new one
        for old in self.all_steps()[:-self.max_to_keep]:
            self.path(old).unlink(missing_ok=True)
        return True

    def read(self, step: int | None = None, device="cpu") -> dict:
        """The checkpoint of step ``step`` (default: the latest): ``step``,
        ``model`` (its state dict, running statistics included) and
        ``optimizer``, with tensors on ``device``."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(
                "no checkpoint found under {}".format(self.directory))
        return torch.load(self.path(step), map_location=device,
                          weights_only=True)

    def restore(self, state, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``state`` in place
        and return it; a tensor-parallel model takes its blocks of the
        full tensors."""
        data = self.read(step, next(state.model.parameters()).device)
        model, opt = state.model, state.optimizer
        state.model.load_state_dict(
            parallel.block_state_dict(model, data["model"]), strict=True)
        state.optimizer.load_state_dict(
            parallel.block_optimizer_state(model, opt, data["optimizer"])
            if parallel.tp_keys(model) else data["optimizer"])
        state.step = int(data["step"])
        return state
