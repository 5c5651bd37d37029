"""Model factory: SSD over the VGG16 backbone.

Counterpart of ``odtpu/models/__init__.py``. Feature-map dims are probed
with a forward on the ``meta`` device (shapes only, no compute), the
counterpart of ``jax.eval_shape``, and the priors are generated from
those dims.
"""

from __future__ import annotations

import torch

from ..ops.priors import prior_factory
from .common import L2Norm
from .ssd import EXTRAS_SPEC, SSD, MultiBoxHead, parse_extras
from .vgg import VGG16

__all__ = ["SSD", "VGG16", "L2Norm", "MultiBoxHead", "EXTRAS_SPEC",
           "parse_extras", "compute_dtype", "create_model",
           "probe_layer_dims", "model_factory", "init_weights"]

# families and bases of odtpu that are not ported yet (ROADMAP Queue 1
# item 7, "the other detector families")
_NOT_PORTED = {"SSD_COCO", "FPN", "FSSD", "RFBNet", "DRN_SSD", "RefineDet",
               "drn_d_22", "drn_d_24"}

# float64 is the numerical reference that float32 runs are held to
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def compute_dtype(cfg) -> torch.dtype:
    """``cfg.TPU.COMPUTE_DTYPE`` as a torch dtype.

    For float32 this also turns TF32 off for matmuls and cuDNN convs
    (cuDNN defaults to TF32, which keeps ~3 decimal digits), so float32
    means float32 on the card.
    """
    name = str(cfg.TPU.COMPUTE_DTYPE)
    if name not in _DTYPES:
        raise ValueError("COMPUTE_DTYPE {!r}; known: {}".format(
            name, sorted(_DTYPES)))
    if name == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return _DTYPES[name]


def _extras_for(cfg):
    size = cfg.MODEL.IMAGE_SIZE[-1]
    return tuple(cfg.MODEL.EXTRAS) or tuple(EXTRAS_SPEC["ssd" + str(size)])


def create_model(cfg):
    """(SSD module on the current default device, prior generator)."""
    for key in (cfg.MODEL.SSD_TYPE, cfg.MODEL.BASE):
        if key in _NOT_PORTED:
            raise NotImplementedError(
                "{} is not ported to odtpu_torch yet (ROADMAP Queue 1 item "
                "7, the other detector families)".format(key))
    if cfg.MODEL.BASE != "vgg16":
        raise KeyError("unknown base {!r}".format(cfg.MODEL.BASE))
    if cfg.MODEL.SSD_TYPE != "SSD":
        raise KeyError("unknown detector {!r}".format(cfg.MODEL.SSD_TYPE))
    dtype = compute_dtype(cfg)
    prior = prior_factory(cfg)
    num_priors = prior.num_priors
    cfg.MODEL.NUM_PRIOR = num_priors
    model = SSD(VGG16(dtype=dtype), cfg.MODEL.NUM_CLASSES, num_priors,
                _extras_for(cfg), dtype=dtype)
    return model, prior


def probe_layer_dims(cfg) -> list[tuple[int, int]]:
    """Source feature-map (H, W) for cfg's model, from a meta forward."""
    h, w = cfg.MODEL.IMAGE_SIZE
    with torch.device("meta"):
        model, _ = create_model(cfg)
        _, _, sources = model(torch.empty(1, h, w, 3), return_sources=True)
    return [(int(s.shape[2]), int(s.shape[3])) for s in sources]


# flax's truncated normals are cut at 2 std and scaled up by 1 / this,
# so the truncated draw keeps the variance asked for
_TRUNC_STD = 0.87962566103423978


def init_weights(model: SSD, seed: int = 0) -> SSD:
    """Seeded random init on the CPU, so every device gets the same
    weights, from ``odtpu``'s distributions: the trunk and extras
    truncated He-normal (flax's ``he_normal``, ``odtpu``'s ``Conv``
    default, ``odtpu/models/common.py:155``), the heads xavier-uniform
    (``odtpu/models/ssd.py:75,78``), zero biases, L2Norm scale 20."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, torch.nn.Conv2d):
                continue
            fan_out, fan_in = m.weight.shape[0], m.weight[0].numel()
            rf = m.weight[0, 0].numel()
            if name.startswith("head."):
                a = (6.0 / (fan_in + fan_out * rf)) ** 0.5
                m.weight.uniform_(-a, a, generator=g)
            else:
                std = (2.0 / fan_in) ** 0.5 / _TRUNC_STD
                torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                            2.0 * std, generator=g)
            m.bias.zero_()
        model.l2norm.scale.fill_(20.0)
    return model


def model_factory(phase, cfg, device="cuda", seed: int = 0):
    """(model, priors [P, 4] on ``device``, layer_dims), mirroring the
    reference factory contract (lib/models/__init__.py:27-34). The model
    has seeded random weights; load a state dict over them to serve
    trained ones. ``phase`` is accepted for parity."""
    del phase
    layer_dims = probe_layer_dims(cfg)
    with torch.device("cpu"):
        model, prior = create_model(cfg)
    if len(layer_dims) != len(prior.num_priors):
        raise ValueError(
            "model produced {} source maps but prior spec has {} entries"
            .format(len(layer_dims), len(prior.num_priors)))
    init_weights(model, seed)
    priors = torch.from_numpy(prior(layer_dims)).to(device)
    return model.to(device), priors, layer_dims
