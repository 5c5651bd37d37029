"""Eval-mode batch norm in flax's order: the CUDA kernel, its plain twin,
and the dispatch between them.

flax's ``nn.BatchNorm(use_running_average=True)`` in float32
(``odtpu/models/common.py:177-180``) computes, per channel,
``mul = rsqrt(var + eps) * scale`` and then ``(x - mean) * mul + bias``,
each operation rounded on its own. :func:`bn_eval` takes ``x`` (NCHW,
contiguous or channels-last, bfloat16, float32 or float64) and the
per-channel ``mean``, ``mul`` and ``bias`` in float32 (float64 for a
float64 ``x``), and returns ``y`` in ``x``'s dtype and layout:

- :func:`bn_eval_cuda`: the kernel ``csrc/batch_norm.cu``, one pass
  (read ``x``, write ``y``), the product and the sum rounded apart;
- :func:`bn_eval_plain`: the same in plain torch, in four passes where
  the output is narrower than float32 (on CUDA ``torch.add(...,
  out=bf16)`` goes through a float32 temporary), bit-equal to the
  kernel.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version;
there is no fallback, and the kernel has no backward (a CUDA call that
needs a gradient raises). While ``torch.export`` traces, the call is the
registered op ``odtpu::bn_eval`` (the same kernel and twin), so that an
exported program runs it too. Live calls skip the op's dispatch, whose
host time a family with 50 norms a forward (RFBNet300) would pay on
every host-bound batch.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import build

# kernel launches in this process; read and reset by callers that need to
# show a run went through the kernel
LAUNCHES = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_FN: list = []


def _kernel():
    if not _FN:
        fn = build.load("batch_norm").odtpu_bn_eval
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the norm computes in for an activation of ``dtype``."""
    return torch.promote_types(dtype, torch.float32)


def bn_eval_plain(x: Tensor, mean: Tensor, mul: Tensor,
                  bias: Tensor) -> Tensor:
    """:func:`bn_eval` in plain torch: ``x - mean`` read in ``x``'s dtype
    and written in the wide one, the product and the sum each rounded
    there, the sum cast to ``x``'s dtype as it is stored (through
    autograd where a gradient is taken: ``out=`` takes none)."""
    y = x - mean[:, None, None]
    y.mul_(mul[:, None, None])
    bias = bias[:, None, None]
    if y.dtype == x.dtype or torch.is_grad_enabled():
        return y.add_(bias).to(x.dtype)
    return torch.add(y, bias, out=torch.empty_like(y, dtype=x.dtype))


def _inner(x: Tensor) -> int | None:
    """H*W for a contiguous NCHW ``x``, 1 for channels-last, else None."""
    if x.is_contiguous():
        return x.shape[2] * x.shape[3]
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    return None


def _check(x: Tensor, mean: Tensor, mul: Tensor, bias: Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise TypeError("want an NCHW bfloat16, float32 or float64 x, got "
                        "{} {}".format(x.dtype, tuple(x.shape)))
    wide = wide_dtype(x.dtype)
    c = x.shape[1]
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.shape != (c,) or t.dtype != wide or not t.is_contiguous():
            raise ValueError("want a contiguous {} [{}] {}, got {} {}"
                             .format(wide, c, name, t.dtype,
                                     tuple(t.shape)))
    if not all(t.is_cuda and t.device == x.device
               for t in (x, mean, mul, bias)):
        raise ValueError("bn_eval_cuda takes CUDA tensors on one device")


def bn_eval_cuda(x: Tensor, mean: Tensor, mul: Tensor,
                 bias: Tensor) -> Tensor:
    """:func:`bn_eval` by the CUDA kernel on the current stream."""
    global LAUNCHES
    _check(x, mean, mul, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, mean, mul, bias)):
        raise RuntimeError("the eval-mode batch-norm kernel has no "
                           "backward; run it under torch.no_grad()")
    c, inner = x.shape[1], _inner(x)
    if inner is None:
        raise ValueError("x must be contiguous or channels-last, got "
                         "strides {}".format(x.stride()))
    y = torch.empty_like(x)
    if x.numel():
        err = _kernel()(x.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                        bias.data_ptr(), y.data_ptr(), x.numel(), c, inner,
                        _DTYPE_CODE[x.dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError("bn_eval kernel launch failed: CUDA error "
                               "{}".format(err))
        LAUNCHES += 1
    return y


@torch.library.custom_op("odtpu::bn_eval", mutates_args=(),
                         device_types="cpu")
def _bn_eval_op(x: Tensor, mean: Tensor, mul: Tensor,
                bias: Tensor) -> Tensor:
    return bn_eval_plain(x, mean, mul, bias)


_bn_eval_op.register_kernel("cuda")(bn_eval_cuda)


@_bn_eval_op.register_fake
def _(x, mean, mul, bias):
    return torch.empty_like(x)


def bn_eval(x: Tensor, mean: Tensor, mul: Tensor, bias: Tensor) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU (and meta)
    tensors, the registered op ``odtpu::bn_eval`` under ``torch.export``."""
    if torch.compiler.is_exporting():
        return torch.ops.odtpu.bn_eval(x, mean, mul, bias)
    if x.is_cuda:
        return bn_eval_cuda(x, mean, mul, bias)
    if x.device.type not in ("cpu", "meta"):  # meta: shapes only
        raise ValueError("no eval-mode batch norm for tensors on {}".format(
            x.device))
    return bn_eval_plain(x, mean, mul, bias)
