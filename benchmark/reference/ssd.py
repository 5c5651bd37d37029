"""SSD300 over VGG16 (Liu et al., SSD, arXiv:1512.02325), plain float32.

VGG16 with the reduced fc, L2Norm (scale 20 at init) on conv4_3, the
extras (1x1 / 3x3 pairs, a source after each pair) and the multibox
heads. ``forward`` takes NHWC images (mean subtracted, RGB) and returns
loc [B, P, 4] and the class logits [B, P, C].
"""

from __future__ import annotations

import torch
from torch import nn

from .common import VGG16, Conv, Ctx, Heads, anchors_per_cell, l2norm

# (features, kernel, stride, padding) of SSD300's extras
EXTRAS_300 = [(256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0),
              (256, 3, 2, 1), (128, 1, 1, 0), (256, 3, 1, 0),
              (128, 1, 1, 0), (256, 3, 1, 0)]


class Model(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = VGG16()
        self.l2norm = nn.Module()
        self.l2norm.scale = nn.Parameter(torch.empty(512))
        cin, channels = 1024, [512, 1024]
        for i, (f, k, s, p) in enumerate(EXTRAS_300):
            self.add_module(f"extras_{i}", Conv(cin, f, k, stride=s,
                                                padding=p))
            if i % 2 == 1:
                channels.append(f)
            cin = f
        self.head = Heads(channels, anchors_per_cell(cfg),
                          cfg["num_classes"])

    def sources(self, x, ctx: Ctx):
        conv4_3, feat = self.backbone(x.permute(0, 3, 1, 2), ctx)
        sources = [l2norm(conv4_3, self.l2norm.scale), feat]
        for i in range(len(EXTRAS_300)):
            feat = getattr(self, f"extras_{i}")(feat, ctx)
            if i % 2 == 1:
                sources.append(feat)
        return sources

    def forward(self, x, ctx: Ctx):
        return self.head(self.sources(x, ctx), ctx)
