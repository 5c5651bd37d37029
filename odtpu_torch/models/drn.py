"""DRN-D: Dilated Residual Network backbones (arch D).

Counterpart of ``odtpu/models/drn.py``. Every conv is batch-normed and
has no bias. Layer plan:

- layer0: 7x7 conv stem, stride 1;
- layer1, layer2: plain conv stages (stride 1, 2);
- layer3, layer4: residual stages, stride 2;
- layer5, layer6: residual stages, dilation 2 and 4, no stride;
- layer7 to layer11: plain conv stages (layer7 stride 2 and dilation 2).

As an SSD base it returns ``([layer6, layer11], layer11)``; with
``out_middle`` it returns every stage's output (DRN_SSD's sources).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .common import Conv


def _bn_conv(in_ch, out_ch, kernel, dtype, **kw) -> Conv:
    return Conv(in_ch, out_ch, kernel, batch_norm=True, dtype=dtype, **kw)


class BasicBlock(nn.Module):
    """Two 3x3 convs with BN and a residual (drn_v3.py:18-52); ``down``
    projects the input where the stride or the width changes."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dilation: tuple = (1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d0, d1 = dilation
        self.conv1 = _bn_conv(in_ch, features, 3, dtype, stride=stride,
                              padding=d0, dilation=d0)
        self.conv2 = _bn_conv(features, features, 3, dtype, padding=d1,
                              dilation=d1, relu=False)
        self.down = (_bn_conv(in_ch, features, 1, dtype, stride=stride,
                              relu=False)
                     if stride != 1 or in_ch != features else None)

    def forward(self, x: Tensor) -> Tensor:
        out = self.conv2(self.conv1(x))
        if self.down is not None:
            x = self.down(x)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4 wide) residual block (drn_v3.py:55-95)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dilation: tuple = (1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d = dilation[1]
        self.conv1 = _bn_conv(in_ch, features, 1, dtype)
        self.conv2 = _bn_conv(features, features, 3, dtype, stride=stride,
                              padding=d, dilation=d)
        self.conv3 = _bn_conv(features, features * 4, 1, dtype, relu=False)
        self.down = (_bn_conv(in_ch, features * 4, 1, dtype, stride=stride,
                              relu=False)
                     if stride != 1 or in_ch != features * 4 else None)

    def forward(self, x: Tensor) -> Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.down is not None:
            x = self.down(x)
        return F.relu(out + x)


class _ConvStage(nn.Sequential):
    """Plain conv + BN + ReLU stack (_make_conv_layers, drn_v3.py:206)."""

    def __init__(self, in_ch: int, features: int, convs: int,
                 stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i in range(convs):
            self.add_module(f"conv_{i}", _bn_conv(
                in_ch if i == 0 else features, features, 3, dtype,
                stride=stride if i == 0 else 1, padding=dilation,
                dilation=dilation))


class _ResStage(nn.Sequential):
    """Residual stage of BasicBlocks (_make_layer, drn_v3.py:182-204)."""

    def __init__(self, in_ch: int, features: int, blocks: int,
                 stride: int = 1, dilation: int = 1, new_level: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dilation == 1:
            first = (1, 1)
        else:
            first = (dilation // 2 if new_level else dilation, dilation)
        self.add_module("block_0", BasicBlock(in_ch, features, stride,
                                              first, dtype))
        for i in range(1, blocks):
            self.add_module(f"block_{i}", BasicBlock(
                features, features, dilation=(dilation, dilation),
                dtype=dtype))


class DRN(nn.Module):
    """Arch-D DRN. ``layers`` (11 entries, layer1..layer11; 0 leaves a
    stage out from layer6 on) and ``channels`` give the plan."""

    def __init__(self, layers: Sequence[int], channels: Sequence[int],
                 out_middle: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        ch, ly = list(channels), list(layers)
        self.layers, self.channels = tuple(ly), tuple(ch)
        self.out_middle = out_middle
        self.layer0 = _bn_conv(3, ch[0], 7, dtype, padding=3)
        plan = [  # (stage, its output channels)
            (_ConvStage(ch[0], ch[0], ly[0], stride=1, dtype=dtype), ch[0]),
            (_ConvStage(ch[0], ch[1], ly[1], stride=2, dtype=dtype), ch[1]),
            (_ResStage(ch[1], ch[2], ly[2], stride=2, dtype=dtype), ch[2]),
            (_ResStage(ch[2], ch[3], ly[3], stride=2, dtype=dtype), ch[3]),
            (_ResStage(ch[3], ch[4], ly[4], dilation=2, new_level=False,
                       dtype=dtype), ch[4])]
        names = ["layer1", "layer2", "layer3", "layer4", "layer5"]
        if ly[5]:
            plan.append((_ResStage(ch[4], ch[5], ly[5], dilation=4,
                                   new_level=False, dtype=dtype), ch[5]))
            names.append("layer6")
        for i in range(6, min(len(ly), 11)):
            if ly[i]:  # layer7 strides and dilates, 8 to 11 do neither
                plan.append((_ConvStage(plan[-1][1], ch[i], ly[i],
                                        stride=2 if i == 6 else 1,
                                        dilation=2 if i == 6 else 1,
                                        dtype=dtype), ch[i]))
                names.append("layer{}".format(i + 1))
        for name, (stage, _) in zip(names, plan):
            self.add_module(name, stage)
        self.stage_names = names
        self.stage_channels = [c for _, c in plan]
        # the SSD source contract: layer6 (or layer5) and the last stage
        self.mid_index = 5 if ly[5] else 4
        self.out_channels = [self.stage_channels[self.mid_index],
                             self.stage_channels[-1]]
        self.final_channels = self.stage_channels[-1]

    def forward(self, x: Tensor):
        x = self.layer0(x)
        y = []
        for name in self.stage_names:
            x = getattr(self, name)(x)
            y.append(x)
        if self.out_middle:
            return y, x
        return [y[self.mid_index], x], x


# (layer1..layer11) plans; both have the same widths
_DRN_CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512, 512, 512, 512)


def drn_d_22(dtype=torch.bfloat16, out_middle=False) -> DRN:
    """drn_v3.py:285 layer plan."""
    return DRN((1, 1, 2, 2, 2, 2, 1, 1, 1, 1, 1), _DRN_CHANNELS,
               out_middle=out_middle, dtype=dtype)


def drn_d_24(dtype=torch.bfloat16, out_middle=False) -> DRN:
    """drn_v5.py:309 ('v30') layer plan, which the reference registers but
    cannot build."""
    return DRN((1, 1, 2, 2, 2, 2, 2, 2, 1, 1, 1), _DRN_CHANNELS,
               out_middle=out_middle, dtype=dtype)
