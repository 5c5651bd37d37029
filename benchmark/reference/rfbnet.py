"""RFBNet512 over VGG16 (Liu, Huang, Wang, RFBNet, arXiv:1711.07767),
plain float32.

conv4_3 -> RFB-a (four branches with 1x3 / 3x1 convs) as source 0;
conv7 -> five RFB blocks (three dilated branches each), then conv_5a /
conv_5b; every conv of the detector body is conv + batch norm (+ ReLU),
with lecun-normal weights at init. An RFB block is
``relu(linear(cat(branches)) * scale + shortcut(x))``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import VGG16, Conv, Ctx, Heads, anchors_per_cell


def basic(cin, cout, kernel=3, stride=1, padding=0, dilation=1,
          relu=True, bn=True):
    return Conv(cin, cout, kernel, stride=stride, padding=padding,
                dilation=dilation, relu=relu, bn=bn, init="lecun_normal")


class RFB(nn.Module):
    """Branches ``b<i>_<j>``, concatenated, projected by ``linear`` and
    added to ``shortcut``."""

    def __init__(self, cin, features, stride, scale, branches):
        super().__init__()
        self.scale = scale
        width = 0
        for i, branch in enumerate(branches):
            for j, conv in enumerate(branch):
                self.add_module(f"b{i}_{j}", conv)
            width += branch[-1].conv.out_channels
        self.depths = [len(b) for b in branches]
        self.linear = basic(width, features, 1, relu=False)
        self.shortcut = basic(cin, features, 1, stride=stride, relu=False)

    def forward(self, x, ctx):
        outs = []
        for i, depth in enumerate(self.depths):
            y = x
            for j in range(depth):
                y = getattr(self, f"b{i}_{j}")(y, ctx)
            outs.append(y)
        out = self.linear(torch.cat(outs, 1), ctx)
        return torch.relu(out * self.scale + self.shortcut(x, ctx))


def rfb(cin, features, stride, visual):
    inter, v, s = cin // 8, visual, stride
    return RFB(cin, features, stride, 1.0, [
        [basic(cin, 2 * inter, 1, stride=s),
         basic(2 * inter, 2 * inter, 3, padding=v, dilation=v, relu=False)],
        [basic(cin, inter, 1),
         basic(inter, 2 * inter, 3, stride=s, padding=1),
         basic(2 * inter, 2 * inter, 3, padding=v + 1, dilation=v + 1,
               relu=False)],
        [basic(cin, inter, 1),
         basic(inter, (inter // 2) * 3, 3, padding=1),
         basic((inter // 2) * 3, 2 * inter, 3, stride=s, padding=1),
         basic(2 * inter, 2 * inter, 3, padding=2 * v + 1,
               dilation=2 * v + 1, relu=False)],
    ])


def rfb_a(cin, features):
    inter = cin // 4
    return RFB(cin, features, 1, 1.0, [
        [basic(cin, inter, 1), basic(inter, inter, 3, padding=1,
                                     relu=False)],
        [basic(cin, inter, 1), basic(inter, inter, (3, 1), padding=(1, 0)),
         basic(inter, inter, 3, padding=3, dilation=3, relu=False)],
        [basic(cin, inter, 1), basic(inter, inter, (1, 3), padding=(0, 1)),
         basic(inter, inter, 3, padding=3, dilation=3, relu=False)],
        [basic(cin, inter // 2, 1),
         basic(inter // 2, (inter // 4) * 3, (1, 3), padding=(0, 1)),
         basic((inter // 4) * 3, inter, (3, 1), padding=(1, 0)),
         basic(inter, inter, 3, padding=5, dilation=5, relu=False)],
    ])


# RFBNet512's blocks after conv7: (features, stride, visual)
BLOCKS_512 = [(1024, 1, 2), (512, 2, 2), (256, 2, 2), (256, 2, 1),
              (256, 2, 1)]


class Model(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = VGG16()
        self.norm_rfb_a = rfb_a(512, 512)
        cin, channels = 1024, [512]
        for i, (f, s, v) in enumerate(BLOCKS_512):
            self.add_module(f"rfb_{i}", rfb(cin, f, s, v))
            channels.append(f)
            cin = f
        self.conv_5a = basic(256, 128, 1)
        self.conv_5b = basic(128, 256, 4, padding=1)
        channels.append(256)
        self.head = Heads(channels, anchors_per_cell(cfg),
                          cfg["num_classes"])

    def sources(self, x, ctx: Ctx):
        conv4_3, feat = self.backbone(x.permute(0, 3, 1, 2), ctx)
        sources = [self.norm_rfb_a(conv4_3, ctx)]
        for i in range(len(BLOCKS_512)):
            feat = getattr(self, f"rfb_{i}")(feat, ctx)
            sources.append(feat)
        sources.append(self.conv_5b(self.conv_5a(feat, ctx), ctx))
        return sources

    def forward(self, x, ctx: Ctx):
        return self.head(self.sources(x, ctx), ctx)
