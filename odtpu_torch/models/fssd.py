"""FSSD: Feature-Fusion SSD (arXiv:1712.00960).

Counterpart of ``odtpu/models/fssd.py``. Three fusion sources: conv4_3
and conv7 (post-ReLU, as ``odtpu`` takes them) and one extra stage (a
1x1 1024->256 and a 3x3/s2 256->512, both without ReLU, as the reference
appends bare convs). Each goes through a 1x1 conv + ReLU to 256
channels, is upsampled to the conv4_3 map, and the three are
concatenated (768 channels) and batch-normed in float32 (``fusion_bn``).
Six pyramid convs (conv + ReLU) then feed the heads.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor, nn

from ..ops.detect import ssd_decode
from .common import BatchNorm2d, Conv, batch_norm
from .fpn import upsample_bilinear
from .ssd import MultiBoxHead, outputs

# (features, stride, padding) per pyramid conv, 300-input spec
FSSD300_PYRAMID = ((512, 1, 1), (512, 2, 1), (256, 2, 1), (256, 2, 1),
                   (256, 1, 0), (256, 1, 0))
FSSD_FUSION_DIM = 256


class FSSD(nn.Module):
    """``forward(x, phase)`` -> (loc, conf), as :class:`SSD`."""

    decode = staticmethod(ssd_decode)

    def __init__(self, backbone: nn.Module, num_classes: int,
                 num_priors: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        d = FSSD_FUSION_DIM
        self.fuse_extra_0 = Conv(backbone.final_channels, d, 1, relu=False,
                                 dtype=dtype)
        self.fuse_extra_1 = Conv(d, 2 * d, 3, stride=2, padding=1,
                                 relu=False, dtype=dtype)
        for i, cin in enumerate(list(backbone.out_channels) + [2 * d]):
            self.add_module(f"transform_{i}", Conv(cin, d, 1, dtype=dtype))
        self.fusion_bn = BatchNorm2d(3 * d, eps=1e-5, momentum=0.1)
        cin, channels = 3 * d, []
        for i, (f, s, p) in enumerate(FSSD300_PYRAMID):
            self.add_module(f"pyramid_{i}", Conv(cin, f, 3, stride=s,
                                                 padding=p, dtype=dtype))
            channels.append(f)
            cin = f
        self.n_pyramid = len(FSSD300_PYRAMID)
        self.head = MultiBoxHead(channels, num_classes, num_priors, dtype)

    def forward(self, x: Tensor, phase: str = "train",
                return_sources: bool = False):
        (conv4_3, conv7), feat = self.backbone(x.permute(0, 3, 1, 2))
        e = self.fuse_extra_1(self.fuse_extra_0(feat))
        up = conv4_3.shape[2:]
        fused = []
        for i, s in enumerate((conv4_3, conv7, e)):
            t = getattr(self, f"transform_{i}")(s)
            fused.append(upsample_bilinear(t, up) if i else t)
        feat = batch_norm(self.fusion_bn, torch.cat(fused, 1), self.dtype)
        pyramids = []
        for i in range(self.n_pyramid):
            feat = getattr(self, f"pyramid_{i}")(feat)
            pyramids.append(feat)
        return outputs(*self.head(pyramids), phase, pyramids,
                       return_sources)
