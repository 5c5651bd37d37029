"""``python -m odtpu_torch.eval``: score a checkpoint or an npz.

Counterpart of ``eval.py`` (the reference's eval.py)::

    python -m odtpu_torch.eval --cfg_name ssd_vgg16_voc [--job_group base]
        [--ckpt DIR | --model_npz NPZ] [--output_dir eval_out]
        [--quant int8] [--device cuda]

builds the detector of one of ``utils.config.CFGS`` by name, or of any
yml by its path (``--cfg``), loads the latest checkpoint of
``--ckpt`` (default ``weights/<job_group>/<cfg_name>/ckpt``) with its
running statistics, or an ``odtpu`` npz with its ``__batch_stats__``, and
runs the serving path's eval step (the CUDA NMS kernel on a card) over
the test set of ``DATASET.DATASET_DIR`` (``data/<SUB_DIR>`` under the
checkout). It prints each class's AP (VOC), the mAP (VOC: mAP@0.5; COCO:
mAP@0.5 and mAP@[.5:.95]) and the evaluator's timing. Without a
checkpoint it warns and scores the seeded init, as ``eval.py`` does.
``--quant int8`` sets ``TPU.QUANT`` and scores with int8 convs
(``ops/quant.py``; the heads stay in the compute dtype), as
``eval.py:51-52`` does.

On a mesh of N processes, one a card (root ``eval.py:53-106`` on a mesh
of devices)::

    python -m torch.distributed.run --nproc_per_node N \
        -m odtpu_torch.eval --multihost [--mesh_model M] \
        [--mesh_spatial S] --cfg_name ssd_vgg16_voc ...

each data index (``N / (M * S)`` of them) scores its slice of the test
set with its part of the model (``models.shard_model``), the rows are
gathered, and every rank computes the same mAP; rank 0 prints and
writes the detection files. ``--quant int8`` runs on a tensor-parallel
mesh (each model rank its channel blocks' int8 GEMMs, the gathered maps
equal to one process's bit for bit) and is refused on a spatial one,
where ``odtpu``'s own int8 step does not compile.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import parallel
from ..data import dataset_factory
from ..infer import Detector
from ..train import add_mesh_args, apply_mesh_args
from ..utils.checkpoint import Checkpointer, load_odtpu_npz
from ..utils.config import resolve_cfg_args
from .evaluator import EvalVOC, eval_solver_factory


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="odtpu_torch evaluation")
    p.add_argument("--cfg_name", default="",
                   help="one of utils.config.CFGS (default ssd_vgg16_voc); "
                        "with --cfg, only the run's name")
    p.add_argument("--job_group", default="", help="default: base")
    p.add_argument("--cfg", default="",
                   help="the path of any yml, laid over the defaults")
    p.add_argument("--ckpt", default="",
                   help="checkpoint dir (default weights/<group>/<name>/"
                        "ckpt); its latest step is scored")
    p.add_argument("--model_npz", default="",
                   help="an odtpu npz (with __batch_stats__ where the "
                        "model has batch norm)")
    p.add_argument("--output_dir", default="eval_out")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="quantized serving compute (overrides TPU.QUANT)")
    p.add_argument("--device", default="cuda",
                   help="with --multihost, cuda is cuda:LOCAL_RANK")
    add_mesh_args(p)
    return p.parse_args(argv)


def setup(args):
    """The cfg ``args`` ask for; the caller may change it (a dataset
    directory, say) before :func:`run`. The mesh (``--mesh_model``,
    ``--mesh_spatial``, in the process group of ``--multihost``) must make
    up the world."""
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    cfg = resolve_cfg_args(args)
    if args.quant:
        cfg.TPU.QUANT = args.quant
    apply_mesh_args(args, cfg)
    return cfg


def _weights(args, cfg):
    """(state dict or None for the seeded init, where it came from)."""
    if args.model_npz:
        return load_odtpu_npz(args.model_npz), args.model_npz
    ckpt = Checkpointer(args.ckpt or os.path.join(
        cfg.GENERAL.WEIGHTS_ROOT, args.job_group, args.cfg_name, "ckpt"))
    if ckpt.latest_step() is None:
        print("WARNING: no checkpoint under {}; evaluating the seeded "
              "init".format(ckpt.directory))
        return None, "seeded init"
    data = ckpt.read()
    print("restored step", data["step"])
    return data["model"], "{} step {}".format(ckpt.directory, data["step"])


def run(args, cfg) -> dict:
    """Score the weights ``args`` name on ``cfg``'s test set; returns the
    per-class results, the mAPs, the timing and where the weights came
    from."""
    solver = eval_solver_factory(dataset_factory("eval", cfg), cfg,
                                 args.output_dir)
    state_dict, source = _weights(args, cfg)
    detector = Detector(cfg, state_dict=state_dict, device=args.device,
                        compact=None)
    res, maps = solver.validate(detector.step)
    if parallel.is_main():
        if isinstance(solver, EvalVOC):
            for cls, ap, _, _ in res:
                print("AP for {} = {:.4f}".format(cls, ap))
        print("mAP:", maps)
        print("timing:", solver.last_timing)
    return {"results": res, "maps": maps, "timing": solver.last_timing,
            "weights": source}


def main(argv=None) -> dict:
    args = parse_args(argv)
    with parallel.distributed(args):
        return run(args, setup(args))
