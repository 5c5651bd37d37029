"""Model zoo: explicit registries and the factory.

Counterpart of ``odtpu/models/__init__.py``: every base (VGG16, with or
without batch norm, DRN-D-22, DRN-D-24) and every detector (SSD,
SSD_COCO, FPN, FSSD, RFBNet, DRN_SSD, RefineDet). Feature-map dims are
probed with a forward on the ``meta`` device (shapes only, no compute),
the counterpart of ``jax.eval_shape``, and the priors are generated from
those dims.
"""

from __future__ import annotations

import copy
import functools

import torch

from .. import parallel
from ..ops.priors import prior_factory
from ..parallel import spatial
from .common import Conv, L2Norm, set_quant
from .drn import DRN, drn_d_22, drn_d_24
from .drnssd import DRNSSD
from .fpn import FPN
from .fssd import FSSD
from .refinedet import RefineDet
from .rfbnet import RFBNet
from .ssd import EXTRAS_SPEC, SSD, MultiBoxHead, parse_extras
from .vgg import VGG16

__all__ = ["SSD", "VGG16", "L2Norm", "MultiBoxHead", "EXTRAS_SPEC",
           "parse_extras", "compute_dtype", "create_model",
           "probe_layer_dims", "model_factory", "init_weights",
           "BASE_REGISTRY", "SSD_REGISTRY", "register_base",
           "register_ssd", "FPN", "FSSD", "RFBNet",
           "RefineDet", "DRN", "DRNSSD", "drn_d_22", "drn_d_24",
           "set_quant", "shard_model", "spatial_plan"]

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


# base name -> builder(cfg, dtype, **what the detector needs of it):
# VGG16's taps and pool5_stride2, a DRN's out_middle
BASE_REGISTRY = {
    "vgg16": lambda cfg, dtype, **kw: VGG16(
        dtype=dtype, batch_norm=bool(cfg.MODEL.BATCH_NORM), **kw),
    "drn_d_22": lambda cfg, dtype, **kw: drn_d_22(dtype=dtype, **kw),
    "drn_d_24": lambda cfg, dtype, **kw: drn_d_24(dtype=dtype, **kw),
}


def _base(cfg, dtype, **kw):
    return BASE_REGISTRY[cfg.MODEL.BASE](cfg, dtype, **kw)


def _extras_for(cfg):
    size = cfg.MODEL.IMAGE_SIZE[-1]
    return tuple(cfg.MODEL.EXTRAS) or tuple(EXTRAS_SPEC["ssd" + str(size)])


def _build_ssd(cfg, num_priors, dtype):
    return SSD(_base(cfg, dtype), cfg.MODEL.NUM_CLASSES, num_priors,
               _extras_for(cfg), dtype=dtype)


def _build_fpn(cfg, num_priors, dtype):
    return FPN(_base(cfg, dtype), cfg.MODEL.NUM_CLASSES, num_priors,
               _extras_for(cfg), dtype=dtype)


def _build_fssd(cfg, num_priors, dtype):
    return FSSD(_base(cfg, dtype), cfg.MODEL.NUM_CLASSES, num_priors,
                dtype=dtype)


def _build_rfb(cfg, num_priors, dtype):
    return RFBNet(_base(cfg, dtype), cfg.MODEL.NUM_CLASSES, num_priors,
                  size=cfg.MODEL.IMAGE_SIZE[-1], dtype=dtype)


def _build_drnssd(cfg, num_priors, dtype):
    return DRNSSD(_base(cfg, dtype, out_middle=True),
                  cfg.MODEL.NUM_CLASSES, num_priors, dtype=dtype)


def _build_refinedet(cfg, num_priors, dtype):
    base = _base(cfg, dtype, taps=("conv4_3", "conv5_3", "conv7"),
                 pool5_stride2=True)
    return RefineDet(base, cfg.MODEL.NUM_CLASSES, num_priors, dtype=dtype)


# detector name -> builder(cfg, num_priors, dtype), which builds its base
SSD_REGISTRY = {
    "SSD": _build_ssd,
    # the reference's SSD_COCO is the same architecture wired without
    # hooks (lib/models/ssd_coco.py:7)
    "SSD_COCO": _build_ssd,
    "FPN": _build_fpn,
    "FSSD": _build_fssd,
    "RFBNet": _build_rfb,
    "DRN_SSD": _build_drnssd,
    "RefineDet": _build_refinedet,
}


def register_base(name, builder):
    """Add a base: ``builder(cfg, dtype, **kw)`` under ``MODEL.BASE`` =
    ``name`` (``odtpu/models/__init__.py:107``)."""
    BASE_REGISTRY[name] = builder


def register_ssd(name, builder):
    """Add a detector: ``builder(cfg, num_priors, dtype)`` under
    ``MODEL.SSD_TYPE`` = ``name`` (``odtpu/models/__init__.py:111``)."""
    SSD_REGISTRY[name] = builder


def create_model(cfg):
    """(detector module on the current default device, prior generator)."""
    if cfg.MODEL.BASE not in BASE_REGISTRY:
        raise KeyError("unknown base {!r}; known: {}".format(
            cfg.MODEL.BASE, sorted(BASE_REGISTRY)))
    if cfg.MODEL.SSD_TYPE not in SSD_REGISTRY:
        raise KeyError("unknown detector {!r}; known: {}".format(
            cfg.MODEL.SSD_TYPE, sorted(SSD_REGISTRY)))
    dtype = compute_dtype(cfg)
    prior = prior_factory(cfg)
    num_priors = prior.num_priors
    cfg.MODEL.NUM_PRIOR = num_priors
    model = SSD_REGISTRY[cfg.MODEL.SSD_TYPE](cfg, tuple(num_priors), dtype)
    return model, prior


def probe_layer_dims(cfg) -> list[tuple[int, int]]:
    """Source feature-map (H, W) for cfg's model, from a meta forward."""
    h, w = cfg.MODEL.IMAGE_SIZE
    with torch.device("meta"):
        model, _ = create_model(cfg)
        model.eval()  # batch norm on one image's 1x1 maps
        sources = model(torch.empty(1, h, w, 3), return_sources=True)[-1]
    return [(int(s.shape[2]), int(s.shape[3])) for s in sources]


# flax's truncated normals are cut at 2 std and scaled up by 1 / this,
# so the truncated draw keeps the variance asked for
_TRUNC_STD = 0.87962566103423978


def _draw_kernel(weight: torch.Tensor, init: str, g: torch.Generator):
    """``init`` (one of ``common.INITS``, by flax's name) into an OIHW
    weight; fans count the receptive field, as flax's do."""
    fan_in = weight[0].numel()
    fan_out = weight.shape[0] * weight[0, 0].numel()
    if init == "zeros":
        weight.zero_()
    elif init == "xavier_uniform":
        a = (6.0 / (fan_in + fan_out)) ** 0.5
        weight.uniform_(-a, a, generator=g)
    else:  # truncated normal, variance 2 or 1 over fan_in
        scale = 2.0 if init == "he_normal" else 1.0
        std = (scale / fan_in) ** 0.5 / _TRUNC_STD
        torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=g)


def init_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random init on the CPU, so every device gets the same
    weights, from ``odtpu``'s distributions, module by module: each conv
    kernel from its ``Conv.init`` (he_normal for ``odtpu``'s ``Conv``
    default, lecun_normal for RFBNet's ``BasicConv``, xavier_uniform for
    the heads, zeros for RefineDet's ARM loc heads), zero biases, each
    L2Norm scale at its ``scale_init``, batch norm at scale 1, bias 0,
    running mean 0 and variance 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                _draw_kernel(m.conv.weight, m.init, g)
                if m.conv.bias is not None:
                    m.conv.bias.zero_()
            elif isinstance(m, L2Norm):
                m.scale.fill_(m.scale_init)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
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


def spatial_plan(cfg) -> spatial.Plan:
    """The H-local ops of ``cfg``'s model, in order, with their global
    heights at ``cfg.MODEL.IMAGE_SIZE``: a forward of the unsharded model
    on the ``meta`` device under ``parallel.spatial.record``."""
    h, w = cfg.MODEL.IMAGE_SIZE
    with torch.device("meta"):
        model, _ = create_model(copy.deepcopy(cfg))
        model.eval()
        with spatial.record(h) as plan:
            model(torch.empty(1, h, w, 3), phase="train")
    return plan


def _mesh_of(cfg):
    """The current mesh, checked against ``cfg.TPU``: the same sizes, and
    no int8 serving on a spatial mesh, where ``odtpu``'s own int8 step
    does not compile."""
    mesh = parallel.current()
    want = parallel.mesh_sizes(cfg, mesh.world)
    if want != (mesh.data, mesh.model, mesh.spatial):
        raise ValueError("cfg.TPU asks for a {} x {} x {} mesh; the run's is "
                         "{} x {} x {} (parallel.make_mesh)".format(
                             *want, mesh.data, mesh.model, mesh.spatial))
    if mesh.spatial > 1 and str(cfg.TPU.QUANT or ""):
        raise NotImplementedError(
            "TPU.QUANT = {!r} with MESH_SPATIAL = {}: odtpu's own int8 "
            "eval step does not compile on a spatial mesh (XLA's HLO "
            "verifier: \"The element types of the operands to Pad do not "
            "match\", an s8 halo pad at conv6); int8 runs on a "
            "tensor-parallel mesh (MESH_MODEL)".format(cfg.TPU.QUANT,
                                                       mesh.spatial))
    return mesh


def shard_model(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """``model`` (full, with its weights) laid out on the current mesh, in
    place; nothing to do unless MESH_MODEL or MESH_SPATIAL is above 1.

    - MESH_MODEL = M: every :class:`Conv` of at least
      ``parallel.mesh.TP_MIN_CHANNELS`` output channels divisible by M
      keeps its model rank's block of them (``odtpu``'s
      ``param_shardings`` rule on OIHW weights), with its bias and its
      batch norm's scale, bias and running statistics, and runs
      tensor-parallel (``Conv.tp``). The blocks are cut from the full
      tensors the model holds, so the layout does not change the init.
      ``model.tp_keys`` names the sharded tensors by state-dict key, with
      their full size (``parallel.full_state_dict``, ``block_of``).
      Everything else, L2Norm's scales and FSSD's ``fusion_bn`` among it,
      is replicated and sees gathered maps. int8 serving (``TPU.QUANT``)
      runs on it: each rank quantizes its blocks' weights (``Conv``).
    - MESH_SPATIAL = S: the forward takes the full batch of images and
      runs on this rank's rows (``parallel.spatial.sharded_forward``
      over :func:`spatial_plan`'s plan); its outputs are whole. int8
      serving is refused there (:func:`_mesh_of`).
    """
    mesh = _mesh_of(cfg)
    if not mesh.sharded:
        return model
    if mesh.model > 1:
        tp = {}
        n_model, m = mesh.model, mesh.m
        for name, mod in model.named_modules():
            if not isinstance(mod, Conv):
                continue
            out = mod.conv.out_channels
            if out < parallel.mesh.TP_MIN_CHANNELS or out % n_model:
                continue
            n = out // n_model
            block = slice(m * n, (m + 1) * n)
            owners = [(mod.conv, ("weight", "bias"))]
            if mod.bn is not None:
                owners.append((mod.bn, ("weight", "bias", "running_mean",
                                        "running_var")))
            for owner, attrs in owners:
                prefix = name + (".conv." if owner is mod.conv else ".bn.")
                for attr in attrs:
                    t = getattr(owner, attr)
                    if t is None:
                        continue
                    cut = t.data[block].clone()
                    setattr(owner, attr, torch.nn.Parameter(
                        cut, t.requires_grad) if isinstance(
                            t, torch.nn.Parameter) else cut)
                    tp[prefix + attr] = out
            mod.conv.out_channels = n
            if mod.bn is not None:
                mod.bn.num_features = n
            mod.tp = True
        model.tp_keys = tp
    if mesh.spatial > 1:
        model.spatial_plan = spatial_plan(cfg)
        model.forward = functools.partial(spatial.sharded_forward, model,
                                          type(model).forward)
    return model
