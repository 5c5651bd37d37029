"""Convert a reference torch checkpoint (``.pth``) to an npz of
``odtpu``'s param paths.

Counterpart of ``tools/convert_torch_weights.py``, key for key and array
for array::

    python -m odtpu_torch.tools.convert_torch_weights src.pth dst.npz \
        [--mode vgg|ssd]

- ``--mode vgg`` (the default): the ``vgg16_reducedfc.pth`` state dict
  the reference trains from, ``N.weight`` or ``base.N.weight``, to
  ``<conv name>/kernel|bias`` (``models.vgg.TORCH_INDEX_TO_NAME``), which
  ``utils.checkpoint.load_backbone_npz`` / ``--basenet`` read.
- ``--mode ssd``: a whole reference SSD (a bare state dict or the
  reference train.py's ``{'iteration', 'step_index', 'state_dict'}``) to
  full param paths, which ``load_model_npz`` / ``load_basenet`` read:
  ``base.N`` -> ``backbone/<conv>/conv``, ``L2Norm.weight`` ->
  ``l2norm/scale``, ``extras.N`` -> ``extras_N/conv``, ``loc.N`` /
  ``conf.N`` -> ``head/{loc,conf}_N/conv``, and FPN's ``transforms.N`` /
  ``pyramids.N`` -> ``transform_N`` / ``pyramid_N``.

Kernels go OIHW -> HWIO; a ``module.`` prefix (a DataParallel save) is
dropped. Keys with no counterpart are printed and skipped.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.vgg import TORCH_INDEX_TO_NAME


def state_dict_of(src) -> dict:
    """The state dict of the ``.pth`` at ``src``: unwrapped from
    ``{'state_dict': ...}`` and without DataParallel's ``module.``."""
    sd = torch.load(src, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _array(value) -> np.ndarray:
    return value if isinstance(value, np.ndarray) else value.numpy()


def convert_vgg_state_dict(sd) -> tuple[dict, list]:
    """A VGG16 state dict -> ({'<conv>/kernel' HWIO, '<conv>/bias'},
    skipped keys)."""
    out, skipped = {}, []
    for key, tensor in sd.items():
        parts = key.split(".")
        # '0.weight' (a bare Sequential) or 'base.0.weight'
        at = 0 if parts[0].isdigit() else 1
        name = TORCH_INDEX_TO_NAME.get(int(parts[at]))
        if name is None:
            skipped.append(key)
            continue
        arr, leaf = _array(tensor), parts[at + 1]
        if leaf == "weight":
            out[name + "/kernel"] = arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            out[name + "/bias"] = arr
    return out, skipped


def convert_ssd_state_dict(sd) -> tuple[dict, list]:
    """A reference SSD state dict (tensors or numpy arrays) -> (arrays by
    ``odtpu`` param path, skipped keys)."""
    out, skipped = {}, []
    for key, tensor in sd.items():
        arr = _array(tensor)
        parts = key.split(".")
        mod = parts[0]
        if mod == "base":
            name = TORCH_INDEX_TO_NAME.get(int(parts[1]))
            if name is None:
                skipped.append(key)
                continue
            path = "backbone/{}/conv/".format(name)
        elif mod == "L2Norm":
            out["l2norm/scale"] = arr
            continue
        elif mod == "extras":
            path = "extras_{}/conv/".format(int(parts[1]))
        elif mod in ("loc", "conf"):
            path = "head/{}_{}/conv/".format(mod, int(parts[1]))
        elif mod in ("transforms", "pyramids"):
            path = "{}_{}/conv/".format(mod[:-1], int(parts[1]))
        else:
            skipped.append(key)
            continue
        leaf = parts[2]
        if leaf == "weight":
            out[path + "kernel"] = arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            out[path + "bias"] = arr
        else:
            skipped.append(key)
    return out, skipped


def convert(src, dst, mode: str = "vgg") -> dict:
    """Convert the ``.pth`` ``src`` to the npz ``dst``; returns the
    arrays written."""
    fn = convert_ssd_state_dict if mode == "ssd" else convert_vgg_state_dict
    out, skipped = fn(state_dict_of(src))
    for key in skipped:
        print("skip", key)
    np.savez(dst, **out)
    print("wrote {} arrays to {}".format(len(out), dst))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="torch checkpoint (.pth)")
    ap.add_argument("dst", help="output .npz")
    ap.add_argument("--mode", choices=["vgg", "ssd"], default="vgg")
    args = ap.parse_args(argv)
    convert(args.src, args.dst, args.mode)


if __name__ == "__main__":
    main()
