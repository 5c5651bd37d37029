"""Shared model building blocks.

Counterpart of ``odtpu/models/common.py`` (lines 92-189). Tensors are
NCHW inside the model. Parameters stay float32; each conv runs in the
block's compute dtype (bfloat16 serving, or float32), as ``odtpu``'s
``param_dtype=float32, dtype=COMPUTE_DTYPE`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn


class Conv(nn.Module):
    """Conv2d + optional ReLU. Batch norm is not ported yet.

    The weight is registered under ``conv`` (``<name>.conv.weight``), as
    ``odtpu``'s param tree has it (``<name>/conv/kernel``).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 relu: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, dilation=dilation)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        c = self.conv
        x = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype),
                     c.bias.to(self.dtype), c.stride, c.padding, c.dilation)
        return F.relu(x) if self.relu else x


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learned per-channel scale.

    The norm is computed in float32 (or wider) and eps is added after the
    sqrt (``odtpu`` common.py:104-111; reference l2norm.py:6, scale init
    20).
    """

    def __init__(self, channels: int, scale_init: float = 20.0,
                 eps: float = 1e-10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), scale_init))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True)) + self.eps
        out = xf / norm * self.scale[None, :, None, None]
        return out.to(self.dtype)


def max_pool_ceil(x: Tensor, window: int = 2, stride: int = 2,
                  padding: int = 0, ceil_mode: bool = False) -> Tensor:
    """Max pool with explicit -inf padding and ceil mode (partial windows
    at the bottom/right count: reference vgg pool3, 75 -> 38)."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)
