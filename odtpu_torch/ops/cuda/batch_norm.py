"""Eval-mode batch norm in flax's order: the CUDA kernel, its plain twin,
the dispatch between them, and its backward.

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
there is no fallback. :func:`bn_eval` itself takes no gradient (a CUDA
call that needs one raises): :class:`BnEvalFn` is the norm with its
backward with respect to ``x``, what ``jax.grad`` with respect to the
input gives through flax's float32 norm and its casts, for a cotangent
``dy`` in ``x``'s dtype and ``W`` the wide dtype: ``dx = cast(W(dy) *
mul)``. On a card it is one more entry of the same kernel source,
:func:`bn_eval_backward_dx_cuda` (one pass); on the CPU
:func:`bn_eval_backward_plain`. The port takes no parameter gradient of
an eval-mode norm (input-gradient saliency switches the parameters'
``requires_grad`` off; train mode runs ``models.common.batch_norm``), so
:class:`BnEvalFn` refuses one. While ``torch.export`` traces,
the call is the registered op ``odtpu::bn_eval`` (the same kernel and
twin, forward only), so that an exported program runs it too. Live calls
skip the op's dispatch, whose host time a family with 50 norms a forward
(RFBNet300) would pay on every host-bound batch.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import build

# kernel launches in this process, by entry; read and reset by callers
# that need to show a run went through the kernel
LAUNCHES = 0
DX_LAUNCHES = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# entry -> its C argument types
_C_ARGS = {
    "odtpu_bn_eval": [_P] * 5 + [_I64, _INT, _I64, _INT, _P],
    "odtpu_bn_eval_backward_dx": [_P] * 3 + [_I64, _INT, _I64, _INT, _P],
}
_FN: dict = {}


def _kernel(name: str = "odtpu_bn_eval"):
    if name not in _FN:
        fn = getattr(build.load("batch_norm"), name)
        fn.argtypes = _C_ARGS[name]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return _FN[name]


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


def _check(x: Tensor, **params: Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise TypeError("want an NCHW bfloat16, float32 or float64 x, got "
                        "{} {}".format(x.dtype, tuple(x.shape)))
    wide = wide_dtype(x.dtype)
    c = x.shape[1]
    for name, t in params.items():
        if t.shape != (c,) or t.dtype != wide or not t.is_contiguous():
            raise ValueError("want a contiguous {} [{}] {}, got {} {}"
                             .format(wide, c, name, t.dtype,
                                     tuple(t.shape)))
    if not all(t.is_cuda and t.device == x.device
               for t in (x, *params.values())):
        raise ValueError("the eval-mode batch-norm kernel takes CUDA tensors "
                         "on one device")


def _layout(x: Tensor) -> int:
    inner = _inner(x)
    if inner is None:
        raise ValueError("x must be contiguous or channels-last, got "
                         "strides {}".format(x.stride()))
    return inner


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
            entry, err))


def bn_eval_cuda(x: Tensor, mean: Tensor, mul: Tensor,
                 bias: Tensor) -> Tensor:
    """:func:`bn_eval` by the CUDA kernel on the current stream."""
    global LAUNCHES
    _check(x, mean=mean, mul=mul, bias=bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, mean, mul, bias)):
        raise RuntimeError("bn_eval has no backward; run it under "
                           "torch.no_grad(), or take BnEvalFn")
    inner = _layout(x)
    y = torch.empty_like(x)
    if x.numel():
        _raise_on(_kernel()(x.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                            bias.data_ptr(), y.data_ptr(), x.numel(),
                            x.shape[1], inner, _DTYPE_CODE[x.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream),
                  "bn_eval")
        LAUNCHES += 1
    return y


def bn_eval_backward_plain(dy: Tensor, mul: Tensor) -> Tensor:
    """The backward of :func:`bn_eval` with respect to ``x`` in plain
    torch: ``cast(W(dy) * mul)`` in ``dy``'s dtype and layout."""
    return (dy.to(mul.dtype) * mul[:, None, None]).to(dy.dtype)


def bn_eval_backward_dx_cuda(dy: Tensor, mul: Tensor) -> Tensor:
    """``cast(W(dy) * mul)`` by the kernel's dx entry, one pass, in
    ``dy``'s dtype and layout (contiguous or channels-last)."""
    global DX_LAUNCHES
    _check(dy, mul=mul)
    inner = _layout(dy)
    dx = torch.empty_like(dy)
    if dy.numel():
        _raise_on(_kernel("odtpu_bn_eval_backward_dx")(
            dy.data_ptr(), mul.data_ptr(), dx.data_ptr(), dy.numel(),
            dy.shape[1], inner, _DTYPE_CODE[dy.dtype],
            torch.cuda.current_stream(dy.device).cuda_stream),
            "bn_eval_backward_dx")
        DX_LAUNCHES += 1
    return dx


def bn_eval_backward_dx(dy: Tensor, mul: Tensor) -> Tensor:
    """The dx entry for CUDA tensors, its plain version for CPU ones."""
    return bn_eval_backward_dx_cuda(dy, mul) if dy.is_cuda \
        else bn_eval_backward_plain(dy, mul)


class BnEvalFn(torch.autograd.Function):
    """:func:`bn_eval` with its backward with respect to ``x``:
    ``BnEvalFn.apply(x, mean, mul, bias)``. On a card the forward is the
    kernel and the backward its dx entry; on the CPU their plain versions.
    ``mean``, ``mul`` and ``bias`` must not need a gradient."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias):
        if any(ctx.needs_input_grad[1:]):
            raise RuntimeError(
                "BnEvalFn gives no gradient of mean, mul or bias: switch "
                "the norm's requires_grad off (as input-gradient saliency "
                "does), or train it in train mode")
        ctx.save_for_backward(mul)
        ctx.layout = (torch.channels_last
                      if _inner(x) == 1 and not x.is_contiguous()
                      else torch.contiguous_format)
        if x.is_cuda:
            return bn_eval_cuda(x, mean, mul, bias)
        return bn_eval_plain(x, mean, mul, bias)

    @staticmethod
    def backward(ctx, dy):
        mul, = ctx.saved_tensors
        # the cotangent in x's layout (a sum's is an expanded tensor)
        dy = dy.contiguous(memory_format=ctx.layout)
        return bn_eval_backward_dx(dy, mul), None, None, None


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
