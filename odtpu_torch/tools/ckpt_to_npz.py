"""Export a port checkpoint as ``odtpu``'s portable npz.

Counterpart of ``tools/ckpt_to_npz.py``, reading the port's
``Checkpointer`` directory instead of an orbax one::

    python -m odtpu_torch.tools.ckpt_to_npz --cfg_name NAME --ckpt DIR \
        --out X.npz [--dtype float16|float32]

The keys are ``odtpu``'s '/'-joined param paths (kernels HWIO), and the
batch norms' running statistics go under ``__batch_stats__/``
(``utils.checkpoint.to_odtpu_params``), so ``odtpu``'s ``eval.py
--model_npz`` (``odtpu.utils.checkpoint.load_variables_npz``) scores a
model the port trained, and the port's ``--model_npz`` reads it back.
``--dtype float16`` (the default, as ``odtpu``'s) halves the file and
rounds every value to float16.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from ..models import create_model
from ..utils.checkpoint import Checkpointer, load_strict, to_odtpu_params
from ..utils.config import resolve_cfg_args


def convert(cfg, ckpt: str, out: str, dtype: str = "float16") -> dict:
    """Write the latest step of the checkpoint ``ckpt`` of a ``cfg`` model
    to the npz ``out`` in ``dtype``; returns the arrays written. The state
    dict must fit ``cfg``'s model."""
    state_dict = Checkpointer(ckpt).read()["model"]
    with torch.device("meta"):  # the keys and shapes alone: no init
        model, _ = create_model(cfg)
    load_strict(model.to_empty(device="cpu"), state_dict)
    arrays = {k: v.astype(dtype)
              for k, v in to_odtpu_params(state_dict).items()}
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    return arrays


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg_name", default="",
                   help="one of utils.config.CFGS (default ssd_vgg16_voc)")
    p.add_argument("--cfg", default="",
                   help="the path of any yml, laid over the defaults")
    p.add_argument("--ckpt", required=True, help="a port checkpoint dir")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--dtype", default="float16",
                   choices=["float16", "float32"])
    args = p.parse_args(argv)
    cfg = resolve_cfg_args(args)
    arrays = convert(cfg, args.ckpt, args.out, args.dtype)
    stats = sum(k.startswith("__batch_stats__/") for k in arrays)
    if stats:
        print("carrying {} batch_stats arrays".format(stats))
    nbytes = sum(v.nbytes for v in arrays.values())
    print("wrote {} ({} tensors, {:.1f} MB raw, {:.1f} MB on disk)".format(
        args.out, len(arrays), nbytes / 1e6, osp.getsize(args.out) / 1e6))


if __name__ == "__main__":
    main()
