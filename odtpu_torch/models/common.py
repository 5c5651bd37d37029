"""Shared model building blocks.

Counterpart of ``odtpu/models/common.py`` (lines 92-189). Tensors are
NCHW inside the model. Parameters stay float32; each conv runs in the
block's compute dtype (bfloat16 serving, or float32), as ``odtpu``'s
``param_dtype=float32, dtype=COMPUTE_DTYPE`` does. Batch norm runs in
float32 (or wider) and casts back, as ``odtpu``'s does.

Every conv of every family is a :class:`Conv`, so int8 serving has one
switch: :func:`set_quant` sets the mode on each of a model's ``Conv``
modules, the counterpart of ``odtpu``'s trace-time ``quantized(mode)``
(lines 15-89). Under ``"int8"`` a ``quantizable`` conv runs
``ops.quant.conv_int8``; the loc/conf heads opt out and stay in the
compute dtype.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .. import parallel
from ..ops import quant
from ..parallel import spatial
from ..ops.cuda import batch_norm as bn_ops

# the serving modes of ``TPU.QUANT``: off, or dynamic int8
QUANT_MODES = ("", "int8")

# the kernel initializers of odtpu's modules, by flax's name: ``Conv``
# defaults to he_normal, ``rfbnet.BasicConv`` takes flax's default
# lecun_normal, the heads xavier_uniform and RefineDet's ARM loc heads
# zeros (``models.init_weights`` draws them)
INITS = ("he_normal", "lecun_normal", "xavier_uniform", "zeros")


# True while a checkpointed forward is recomputed for its backward
# (``TPU.REMAT``): train-mode batch norm then leaves the running
# statistics as the first forward left them
_RECOMPUTING = False


@contextlib.contextmanager
def recomputing():
    """Mark a forward as the recompute of one already run: the batch norms
    normalise with the batch's statistics as before (the same input
    gives the same statistics) and do not move their running ones again,
    as flax's functional ``jax.checkpoint`` never does; its halo bytes
    count under ``parallel.spatial.SENT["recompute"]``."""
    global _RECOMPUTING
    outer, _RECOMPUTING = _RECOMPUTING, True
    try:
        with spatial.counted_as("recompute"):
            yield
    finally:
        _RECOMPUTING = outer


def float32_or_wider(x: Tensor) -> Tensor:
    """``x`` in float32, or as it is when wider (a float64 step)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_norm(bn: BatchNorm2d, x: Tensor, dtype: torch.dtype) -> Tensor:
    """``bn`` applied in float32 (or wider), cast back to ``dtype``.

    In eval mode it normalises with the running statistics in flax's
    order, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    (:class:`BatchNorm2d`'s forward). In train mode it follows flax's
    ``nn.BatchNorm(use_running_average=False)``: the batch's mean and
    *biased* variance over (N, H, W) normalise in the same order, and
    the running statistics move by ``running = (1 - momentum) * running
    + momentum * batch_stat`` with that biased variance
    (``nn.BatchNorm2d`` would take the unbiased one, n / (n - 1) larger,
    and it refuses one value a channel, where this gives the bias).

    The fused batch norm normalises and hands back the batch's mean and
    unbiased variance, from which the biased one follows. For one value a
    channel, which it refuses, the statistics are computed directly, with
    autograd through them, as flax's are: the variance is 0 and the
    output the bias.

    On a mesh (``parallel``) the statistics are the global batch's, as
    flax's are under ``odtpu``'s sharded batch: the direct computation
    with the sums, the squared deviations about the mean and the counts
    of values a channel taken over the replica group (the data indices'
    batches and the spatial ranks' rows of this rank's channels) by a
    differentiable all-reduce, so that each rank's share of the loss
    reaches every rank's inputs through them. A rank may hold no rows.
    """
    if not bn.training:
        return bn(x).to(dtype)
    x = float32_or_wider(x)
    weight, bias = bn.weight.to(x.dtype), bn.bias.to(x.dtype)
    c = x.shape[1]
    n = x.numel() // c
    if parallel.axis_size("replica") > 1:
        sums = parallel.all_reduce_sum(torch.cat([x.sum((0, 2, 3)),
                                                  x.new_full((1,), n)]))
        count = sums[c]
        mean = (sums[:c] / count).view(1, c, 1, 1)
        xc = x - mean
        var = (parallel.all_reduce_sum(xc.square().sum((0, 2, 3)))
               / count).view(1, c, 1, 1)
        mul = torch.rsqrt(var + bn.eps) * weight[:, None, None]
        y = torch.addcmul(bias[:, None, None], xc, mul)
    elif n > 1:
        # buffers at 0 that take the batch's statistics whole (momentum
        # 1): 0 + (stat - 0) is stat exactly
        mean = torch.zeros_like(bn.running_mean, dtype=x.dtype)
        var = torch.zeros_like(bn.running_var, dtype=x.dtype)
        y = F.batch_norm(x, mean, var, weight, bias, True, 1.0, bn.eps)
        var = var * ((n - 1) / n)
    else:
        mean = x.mean((0, 2, 3), keepdim=True)
        xc = x - mean
        var = xc.square().mean((0, 2, 3), keepdim=True)
        mul = torch.rsqrt(var + bn.eps) * weight[:, None, None]
        y = torch.addcmul(bias[:, None, None], xc, mul)
    if _RECOMPUTING:
        return y.to(dtype)
    with torch.no_grad():
        for running, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            running.mul_(1.0 - bn.momentum).add_(
                stat.detach().flatten().to(running.dtype),
                alpha=bn.momentum)
    return y.to(dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose eval-mode forward is flax's
    ``nn.BatchNorm(use_running_average=True)`` (``odtpu`` common.py:
    177-180): ``mul = rsqrt(var + eps) * scale`` in float32 (float64 for
    a float64 ``x``), then ``(x - mean) * mul + bias`` with the product
    and the sum rounded apart (``nn.BatchNorm2d``'s own arithmetic rounds
    otherwise, and int8 serving spreads a last-bit difference), by
    ``ops.cuda.batch_norm.bn_eval``: one kernel pass on a card. Where a
    gradient is taken through it on a card (input-gradient saliency, with
    the parameters' ``requires_grad`` off), it runs ``BnEvalFn``, the same
    kernel with its backward with respect to ``x``. The
    result keeps ``x``'s dtype and layout. The same buffers and names as
    ``nn.BatchNorm2d``, so checkpoints and hooks see no difference. Train
    mode goes through :func:`batch_norm`, never this forward."""

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            raise RuntimeError("train-mode batch norm runs through "
                               "models.common.batch_norm")
        params = self.eval_params(x.dtype)
        if x.is_cuda and torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, self.weight, self.bias)):
            return bn_ops.BnEvalFn.apply(x, *params)
        return bn_ops.bn_eval(x, *params)

    def eval_params(self, dtype: torch.dtype) -> tuple:
        """(mean, mul, bias) in the wide dtype of an activation of
        ``dtype``. Where no gradient is taken they are made once per
        version of the statistics and the affine parameters (an
        optimizer step or ``load_state_dict`` makes them anew), which
        spares the serving path three launches a norm."""
        wide = bn_ops.wide_dtype(dtype)
        tensors = (self.running_mean, self.running_var, self.weight,
                   self.bias)
        cache = not (torch.is_grad_enabled()
                     or torch.compiler.is_exporting()
                     or any(t.is_inference() for t in tensors))
        if cache:
            key = (wide,) + tuple((t.data_ptr(), t._version)
                                  for t in tensors)
            hit = self.__dict__.get("_eval_cache")
            if hit is not None and hit[0] == key:
                return hit[1]
        mul = torch.rsqrt(self.running_var.to(wide) + self.eps) \
            * self.weight.to(wide)
        params = (self.running_mean.to(wide).contiguous(), mul.contiguous(),
                  self.bias.to(wide).contiguous())
        if cache:
            # the key's storages stay alive in the module, so an equal
            # address is the same storage
            self.__dict__["_eval_cache"] = (key, params)
        return params


class Conv(nn.Module):
    """Conv2d + optional batch norm + optional ReLU.

    The weight is registered under ``conv`` (``<name>.conv.weight``) and
    the norm under ``bn``, as ``odtpu``'s param tree has them
    (``<name>/conv/kernel``, ``<name>/bn/scale``). Under batch norm the
    conv has no bias (``odtpu/models/common.py:172``). ``bn_momentum`` is
    torch's: flax's 0.9 (``Conv``) is 0.1 here, flax's 0.99
    (``rfbnet.BasicConv``) 0.01. ``kernel`` and ``padding`` take an int or
    an (h, w) pair. ``quantizable=False`` keeps the conv in the compute
    dtype under int8 serving (the loc/conf heads, as ``odtpu``'s).

    On a mesh (``parallel``) ``tp`` marks a conv that holds its model
    rank's block of output channels (``models.shard_model``): its input
    passes ``parallel.to_model_group`` and its output, after the bias,
    the norm and the ReLU, ``parallel.gather_model_group``. Under int8
    serving such a conv quantizes the whole map it takes (one scale an
    image, the same on every model rank) and runs the int8 GEMM of its
    block, whose per-channel weight scales are its slice of the full
    ones: the int32 sums are exact and the rescale, bias, norm and ReLU
    act element by element, so the gathered map is one process's bit for
    bit. Under a spatial plan the conv computes its rank's rows
    (``parallel.spatial.conv2d``).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel=3, stride: int = 1,
                 padding=0, dilation: int = 1, relu: bool = True,
                 batch_norm: bool = False, bn_momentum: float = 0.1,
                 init: str = "he_normal",
                 dtype: torch.dtype = torch.bfloat16,
                 quantizable: bool = True):
        super().__init__()
        if init not in INITS:
            raise ValueError("init {!r}; known: {}".format(init, INITS))
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, dilation=dilation,
                              bias=not batch_norm)
        self.bn = (BatchNorm2d(out_ch, eps=1e-5, momentum=bn_momentum)
                   if batch_norm else None)
        self.relu = relu
        self.init = init
        self.dtype = dtype
        self.quantizable = quantizable
        self.quant = ""  # set model-wide by set_quant
        self.tp = False  # set by models.shard_model
        # the int8 weight operand, made once per version of the weight
        self.int8_cache = {}

    def forward(self, x: Tensor) -> Tensor:
        c = self.conv
        if self.tp:
            x = parallel.to_model_group(x)
        bias = None if c.bias is None else c.bias.to(self.dtype)
        if self.quant and self.quantizable:
            # x as it arrives, not cast: odtpu's _QuantConv quantizes the
            # uncast input (the first conv's float32 image)
            x = quant.conv_int8(x, c.weight, c.stride, c.padding,
                                c.dilation, self.dtype, self.int8_cache)
            if bias is not None:
                x = x + bias[:, None, None]
        else:
            x = spatial.conv2d(x.to(self.dtype), c.weight.to(self.dtype),
                               bias, c.stride, c.padding, c.dilation)
        if self.bn is not None:
            x = batch_norm(self.bn, x, self.dtype)
        if self.relu:
            x = F.relu(x)
        return parallel.gather_model_group(x) if self.tp else x


def quant_mode(mode) -> str:
    """``mode`` ("" or None for off, or "int8") as one of
    :data:`QUANT_MODES`; raises on any other."""
    mode = str(mode or "")
    if mode not in QUANT_MODES:
        raise ValueError("unknown quant mode {!r} (expected 'int8')".format(
            mode))
    return mode


def set_quant(model: nn.Module, mode: str) -> str:
    """Set every :class:`Conv` of ``model`` to serve in ``mode`` (see
    :func:`quant_mode`); returns the mode its first ``Conv`` had, so a
    caller can put it back."""
    mode = quant_mode(mode)
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    previous = convs[0].quant if convs else ""
    for m in convs:
        m.quant = mode
    return previous


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learned per-channel scale.

    The norm is computed in float32 (or wider) and eps is added after the
    sqrt (``odtpu`` common.py:104-111; reference l2norm.py:6). The scale
    starts at ``scale_init``: 20 on SSD's conv4_3, 10 and 8 on RefineDet's
    conv4_3 and conv5_3.
    """

    def __init__(self, channels: int, scale_init: float = 20.0,
                 eps: float = 1e-10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), scale_init))
        self.scale_init = scale_init
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        xf = float32_or_wider(x)
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True)) + self.eps
        out = xf / norm * self.scale[None, :, None, None]
        return out.to(self.dtype)


def max_pool_ceil(x: Tensor, window: int = 2, stride: int = 2,
                  padding: int = 0, ceil_mode: bool = False) -> Tensor:
    """Max pool with explicit -inf padding and ceil mode (partial windows
    at the bottom/right count: reference vgg pool3, 75 -> 38); under a
    spatial plan, this rank's rows (``parallel.spatial.max_pool2d``)."""
    return spatial.max_pool2d(x, window, stride, padding, ceil_mode)
