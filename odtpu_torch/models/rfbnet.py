"""RFBNet: Receptive Field Block SSD (arXiv:1711.07767), at 300 and 512.

Counterpart of ``odtpu/models/rfbnet.py``, the canonical VGG wiring:
conv4_3 -> ``BasicRFBa`` as source 0, conv7 -> the RFB extras. Every
conv is a ``BasicConv``: no bias under batch norm, torch momentum 0.01
(flax 0.99), flax's default lecun_normal init. An RFB block runs
parallel dilated branches, a 1x1 linear projection and a scaled
shortcut: ``relu(out * scale + shortcut(x))``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..ops.detect import ssd_decode
from .common import Conv
from .ssd import MultiBoxHead, outputs


def BasicConv(in_ch: int, out_ch: int, kernel=3, stride: int = 1,
              padding=0, dilation: int = 1, relu: bool = True,
              bn: bool = True, dtype: torch.dtype = torch.bfloat16) -> Conv:
    """conv + optional BN + optional ReLU (rfb_net.py:11-26)."""
    return Conv(in_ch, out_ch, kernel, stride=stride, padding=padding,
                dilation=dilation, relu=relu, batch_norm=bn,
                bn_momentum=0.01, init="lecun_normal", dtype=dtype)


class _RFB(nn.Module):
    """Branches ``b<i>_<j>`` run in sequence, concatenated, projected by
    ``linear`` and added to ``shortcut``."""

    def _finish(self, in_ch, features, stride, scale, branches, dtype):
        self.scale = scale
        width = 0
        for i, branch in enumerate(branches):
            for j, conv in enumerate(branch):
                self.add_module(f"b{i}_{j}", conv)
            width += branch[-1].conv.out_channels
        self.depths = [len(b) for b in branches]
        self.linear = BasicConv(width, features, 1, relu=False, dtype=dtype)
        self.shortcut = BasicConv(in_ch, features, 1, stride=stride,
                                  relu=False, dtype=dtype)
        self.out_channels = features

    def forward(self, x: Tensor) -> Tensor:
        outs = []
        for i, depth in enumerate(self.depths):
            y = x
            for j in range(depth):
                y = getattr(self, f"b{i}_{j}")(y)
            outs.append(y)
        out = self.linear(torch.cat(outs, 1))
        return F.relu(out * self.scale + self.shortcut(x))


class BasicRFB(_RFB):
    """3-branch receptive-field block (rfb_net.py:29-67)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 scale: float = 0.1, visual: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        inter, v, s = in_ch // 8, visual, stride

        def c(*a, **k):
            return BasicConv(*a, dtype=dtype, **k)

        self._finish(in_ch, features, stride, scale, [
            [c(in_ch, 2 * inter, 1, stride=s),
             c(2 * inter, 2 * inter, 3, padding=v, dilation=v, relu=False)],
            [c(in_ch, inter, 1),
             c(inter, 2 * inter, 3, stride=s, padding=1),
             c(2 * inter, 2 * inter, 3, padding=v + 1, dilation=v + 1,
               relu=False)],
            [c(in_ch, inter, 1),
             c(inter, (inter // 2) * 3, 3, padding=1),
             c((inter // 2) * 3, 2 * inter, 3, stride=s, padding=1),
             c(2 * inter, 2 * inter, 3, padding=2 * v + 1,
               dilation=2 * v + 1, relu=False)],
        ], dtype)


class BasicRFBa(_RFB):
    """4-branch RFB-a with asymmetric 1x3/3x1 convs (rfb_net.py:71-117),
    on the conv4_3-level feature."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 scale: float = 1.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        inter, s = in_ch // 4, stride

        def c(*a, **k):
            return BasicConv(*a, dtype=dtype, **k)

        self._finish(in_ch, features, stride, scale, [
            [c(in_ch, inter, 1),
             c(inter, inter, 3, padding=1, relu=False)],
            [c(in_ch, inter, 1),
             c(inter, inter, (3, 1), padding=(1, 0)),
             c(inter, inter, 3, padding=3, dilation=3, relu=False)],
            [c(in_ch, inter, 1),
             c(inter, inter, (1, 3), stride=s, padding=(0, 1)),
             c(inter, inter, 3, padding=3, dilation=3, relu=False)],
            [c(in_ch, inter // 2, 1),
             c(inter // 2, (inter // 4) * 3, (1, 3), padding=(0, 1)),
             c((inter // 4) * 3, inter, (3, 1), stride=s, padding=(1, 0)),
             c(inter, inter, 3, padding=5, dilation=5, relu=False)],
        ], dtype)


class RFBNet(nn.Module):
    """RFBNet300/512 over a VGG16 backbone; ``forward`` as :class:`SSD`."""

    decode = staticmethod(ssd_decode)

    def __init__(self, backbone: nn.Module, num_classes: int,
                 num_priors: Sequence[int], size: int = 300,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        c43 = backbone.out_channels[0]
        self.norm_rfb_a = BasicRFBa(c43, c43, scale=1.0, dtype=dtype)
        cin = backbone.final_channels
        if size == 300:
            rfbs = [(512, 1), (512, 2), (256, 2)]
            tail = [("conv_3a", 128, 1, 0, True),
                    ("conv_3b", 256, 3, 0, True),
                    ("conv_4a", 128, 1, 0, True),
                    ("conv_4b", 256, 3, 0, False)]
        elif size == 512:
            rfbs = [(1024, 1), (512, 2), (256, 2), (256, 2), (256, 2)]
            tail = [("conv_5a", 128, 1, 0, True),
                    ("conv_5b", 256, 4, 1, True)]
        else:
            raise ValueError("RFBNet supports size 300 or 512")
        channels = [c43]
        for i, (f, s) in enumerate(rfbs):
            # odtpu picks visual 1 for a later block that takes 256
            # channels in, from the width it sees at run time
            # (rfbnet.py:203): only the 512 net has such blocks
            visual = 1 if i > 0 and cin == 256 else 2
            self.add_module(f"rfb_{i}", BasicRFB(cin, f, stride=s, scale=1.0,
                                                 visual=visual, dtype=dtype))
            channels.append(f)
            cin = f
        self.tail = [name for name, *_ in tail]
        for name, f, k, p, bn in tail:
            self.add_module(name, BasicConv(cin, f, k, padding=p, bn=bn,
                                            dtype=dtype))
            cin = f
        channels += [f for _, f, *_ in tail][1::2]
        self.n_rfb = len(rfbs)
        self.head = MultiBoxHead(channels, num_classes, num_priors, dtype)

    def forward(self, x: Tensor, phase: str = "train",
                return_sources: bool = False):
        (conv4_3, _), feat = self.backbone(x.permute(0, 3, 1, 2))
        sources = [self.norm_rfb_a(conv4_3)]
        for i in range(self.n_rfb):
            feat = getattr(self, f"rfb_{i}")(feat)
            sources.append(feat)
        for k, name in enumerate(self.tail):
            feat = getattr(self, name)(feat)
            if k % 2 == 1:  # a source after each pair of convs
                sources.append(feat)
        return outputs(*self.head(sources), phase, sources, return_sources)
