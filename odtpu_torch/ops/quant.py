"""Dynamic int8 quantized convolution for serving.

Counterpart of ``odtpu/ops/quant.py``:

- weights: symmetric per-output-channel scales, ``s_w = max(max |w| over
  (I, H, W), 1e-12) / 127``, quantized from the float32 weights (any
  checkpoint serves int8 as it is);
- activations: symmetric per-*image* scales, ``s_x = max(max |x| over
  (C, H, W), 1e-12) / 127``, so an image's detections do not depend on
  the rest of its batch;
- the conv: s8 x s8 accumulated in int32, zero padding on ``x_q``, then
  ``(y.float() * (s_x * s_w)).to(out_dtype)``.

:func:`conv_int8` is the serving route on every device: the taps of
``x_q`` in NHWC make an int8 ``[B*Ho*Wo, kh*kw*Cin]`` matrix (a 1x1 conv
of stride 1 is a view of ``x_q``), and ``torch._int_mm`` multiplies it by
the weights as ``[kh*kw*Cin, O]``. On the card that is cuBLASLt's int8
GEMM, which takes M > 16 and K, N multiples of 8: each is padded with
zeros up to that, which is exact, and the result sliced back.
:func:`conv_int8_plain` is its oracle: ``F.conv2d`` in float64 over the
same integers, exact since every partial sum is an integer below 2^53.
It is on no serving path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.fx.experimental.symbolic_shapes import statically_known_true

# torch._int_mm calls made by conv_int8 (the card's int8 GEMM launches)
INT_MM_CALLS = 0

# what cuBLASLt's int8 GEMM takes: M > _MIN_ROWS, K and N multiples of
# _ALIGN
_MIN_ROWS = 16
_ALIGN = 8


def quantize_weight_int8(weight: Tensor) -> tuple[Tensor, Tensor]:
    """An OIHW weight -> (w_q int8 OIHW, s_w float32 [O])."""
    wf = weight.to(torch.float32)
    s_w = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    w_q = torch.round(wf / s_w[:, None, None, None]).to(torch.int8)
    return w_q, s_w


def quantize_act_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """An NCHW activation -> (x_q int8 NCHW, in ``x``'s memory format;
    s_x float32 [B, 1, 1, 1]).

    ``x`` is quantized as it arrives (float32 for the first conv, the
    compute dtype after it): bfloat16 and float32 divide in float32, as
    ``odtpu``'s ``x.astype(float32) / s_x``; float64 is cast first."""
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    # max |x| in one read: the infinity norm, exact in any dtype
    s_x = torch.linalg.vector_norm(x, float("inf"), dim=(1, 2, 3),
                                   keepdim=True, dtype=torch.float32)
    s_x = s_x.clamp_min(1e-12) / 127.0
    x_q = torch.div(x, s_x).round_().to(torch.int8)
    return x_q, s_x


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def weight_operand(weight: Tensor, cache: dict | None = None):
    """(b int8 [Kp, Np], a column-major view, s_w float32 [O]) of an OIHW
    weight: w_q as [O, kh*kw*Cin] with the taps (kh, kw) outer and Cin
    inner, zero-padded to Np rows and Kp columns, multiples of 8.

    With ``cache`` (a dict the caller keeps) the operand is made once per
    version of the weight: it is remade when the weight's storage or its
    version counter changes (an optimizer step, ``load_state_dict``), so
    the train loop's validation never serves stale weights. The cache
    holds the storage alive, so an equal address is the same storage.
    An inference tensor has no version counter and is not cached, nor is
    a weight that ``torch.export`` traces (it has no storage): the
    exported graph quantizes its float32 weights with these same ops."""
    if torch.compiler.is_exporting() or weight.is_inference():
        cache = None
    key = None if cache is None else (
        weight.data_ptr(), weight._version, weight.device, weight.shape)
    if cache is not None and cache.get("key") == key:
        return cache["b"], cache["s_w"]
    w_q, s_w = quantize_weight_int8(weight)
    o = w_q.shape[0]
    w_mat = w_q.permute(0, 2, 3, 1).reshape(o, -1)
    k = w_mat.shape[1]
    w_mat = F.pad(w_mat, (0, _round_up(k, _ALIGN) - k,
                          0, _round_up(o, _ALIGN) - o)).contiguous()
    b = w_mat.t()
    if cache is not None:
        cache.update(key=key, storage=weight.untyped_storage(), b=b, s_w=s_w)
    return b, s_w


def out_size(size: int, k: int, stride: int, pad: int, dilation: int):
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def tap_matrix(x_q: Tensor, kernel, stride, padding, dilation) -> Tensor:
    """int8 NCHW ``x_q`` -> its taps, int8 [B*Ho*Wo, Kp]: for each output
    position the (kh, kw, Cin) window of the zero-padded input, Cin
    innermost, then zeros up to Kp, the next multiple of 8. A 1x1 conv of
    stride 1 and no padding is a view where ``x_q`` is channels-last."""
    b, c, h, w = x_q.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = out_size(h, kh, sh, ph, dh), out_size(w, kw, sw, pw, dw)
    x = x_q.permute(0, 2, 3, 1)  # NHWC; a view when x_q is channels-last
    k = kh * kw * c
    kp = _round_up(k, _ALIGN)
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0) and k == kp:
        return x.reshape(b * ho * wo, c)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    # the windows as a view [B, Ho, Wo, kh, kw, C], copied out in one
    # pass; where each pixel's C bytes are contiguous and a multiple of
    # 8, as int64 words, which the copy moves 8 bytes at a time
    wide = x.stride(-1) == 1 and c % 8 == 0
    if wide:
        x = x.view(torch.int64)
    s_b, s_h, s_w, s_c = x.stride()
    windows = x.as_strided((b, ho, wo, kh, kw, x.shape[-1]),
                           (s_b, s_h * sh, s_w * sw, s_h * dh, s_w * dw, s_c))
    taps = windows.reshape(b * ho * wo, -1)
    if wide:
        return taps.view(torch.int8)
    return F.pad(taps, (0, kp - k)) if kp > k else taps


def int_mm(a: Tensor, b: Tensor) -> Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] by ``torch._int_mm``,
    M zero-padded past 16 where it is not (a batch-1 request's 1x1
    maps), or where a batch-polymorphic export cannot tell."""
    global INT_MM_CALLS
    m = a.shape[0]
    if not statically_known_true(m > _MIN_ROWS):
        a = F.pad(a, (0, 0, 0, _MIN_ROWS + 1))
    y = torch._int_mm(a, b)
    INT_MM_CALLS += 1
    return y[:m]


def rescale(y: Tensor, s_x: Tensor, s_w: Tensor,
            out_dtype: torch.dtype) -> Tensor:
    """int32 NCHW ``y`` -> ``(y.float() * (s_x * s_w)).to(out_dtype)``,
    channels-last, in one pass: the product runs in float32 (int32 and
    float32 promote to it) and is cast to ``out_dtype`` as it is
    stored."""
    scale = s_x * s_w[None, :, None, None]
    b, o, h, w = y.shape
    out = torch.empty((b, h, w, o), dtype=out_dtype,
                      device=y.device).permute(0, 3, 1, 2)
    return torch.mul(y, scale, out=out)


def conv_int8(x: Tensor, weight: Tensor, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1), out_dtype: torch.dtype = torch.float32,
              cache: dict | None = None) -> Tensor:
    """The quantized conv of NCHW ``x`` by the OIHW ``weight`` through
    ``torch._int_mm``; no bias (the caller adds it in ``out_dtype``), and
    no gradient: it serves, as ``odtpu``'s runs only in the eval step.
    The result is NCHW and channels-last, as the GEMM writes it: no copy
    between the GEMM and the rescale. ``cache``: see
    :func:`weight_operand`."""
    if torch.is_grad_enabled():
        # only here: each grad-mode switch is a node that torch.export
        # then splits the int8 graph at
        with torch.no_grad():
            return conv_int8(x, weight, stride, padding, dilation,
                             out_dtype, cache)
    x_q, s_x = quantize_act_int8(x)
    b, s_w = weight_operand(weight, cache)
    o, _, kh, kw = weight.shape
    taps = tap_matrix(x_q, (kh, kw), stride, padding, dilation)
    y = int_mm(taps, b)[:, :o]
    ho = out_size(x.shape[2], kh, stride[0], padding[0], dilation[0])
    wo = out_size(x.shape[3], kw, stride[1], padding[1], dilation[1])
    y = y.reshape(x.shape[0], ho, wo, o).permute(0, 3, 1, 2)
    return rescale(y, s_x, s_w, out_dtype)


@torch.no_grad()
def conv_int8_plain(x: Tensor, weight: Tensor, stride=(1, 1),
                    padding=(0, 0), dilation=(1, 1),
                    out_dtype: torch.dtype = torch.float32,
                    cache: dict | None = None) -> Tensor:
    """:func:`conv_int8` by ``F.conv2d`` in float64 over the same int8
    operands (cuDNN off, so no transform-based algorithm runs): exact, as
    every partial sum is an integer below 2^53. ``cache`` is ignored."""
    del cache
    x_q, s_x = quantize_act_int8(x)
    w_q, s_w = quantize_weight_int8(weight)
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x_q.double(), w_q.double(), None, stride, padding,
                     dilation)
    return rescale(y.to(torch.int32), s_x, s_w, out_dtype)
