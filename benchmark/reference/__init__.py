"""Plain float32 PyTorch reference of the benchmark's configurations.

Imports torch and the standard library only: nothing of the program
under test, of ``odtpu`` or of JAX. A configuration's ``family`` names
the module here that defines its ``Model``; :func:`build` makes one on
the ``meta`` device, to be filled with ``load_state_dict(...,
assign=True)``.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from .common import Ctx, priors


def build(cfg: dict):
    """The reference model of ``cfg`` (a configuration file's dict) on
    ``meta``."""
    module = importlib.import_module(__name__ + "." + cfg["family"])
    with torch.device("meta"):
        return module.Model(cfg)


def layer_dims(cfg: dict) -> list[tuple[int, int]]:
    """The source maps' (H, W) of ``cfg``'s model, from a forward on
    ``meta``."""
    h, w = cfg["image_size"]
    with torch.device("meta"):
        srcs = build(cfg).sources(torch.empty(1, h, w, 3), Ctx())
    return [(int(s.shape[2]), int(s.shape[3])) for s in srcs]


def model_priors(cfg: dict) -> torch.Tensor:
    """Center-size priors [P, 4] of ``cfg``'s model, float32 on the CPU."""
    return priors(cfg, layer_dims(cfg))


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32 (TF32 off) inside."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
