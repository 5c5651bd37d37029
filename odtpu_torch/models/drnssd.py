"""DRN_SSD: multibox heads directly on a DRN's middle stages.

Counterpart of ``odtpu/models/drnssd.py``: sources are L2Norm(y[3]) and
then y[4:4+n-1] of an ``out_middle`` DRN's stage outputs y, for n prior
maps; no extras.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor, nn

from ..ops.detect import ssd_decode
from .common import L2Norm
from .ssd import MultiBoxHead, outputs


class DRNSSD(nn.Module):
    """``forward(x, phase)`` -> (loc, conf), as :class:`SSD`."""

    decode = staticmethod(ssd_decode)

    def __init__(self, backbone: nn.Module, num_classes: int,
                 num_priors: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if not backbone.out_middle:
            raise ValueError("DRN_SSD needs a DRN with out_middle=True")
        self.backbone = backbone
        self.n = n = len(num_priors)
        ch = backbone.stage_channels
        self.l2norm = L2Norm(ch[3], dtype=dtype)
        self.head = MultiBoxHead([ch[3]] + ch[4:4 + n - 1], num_classes,
                                 num_priors, dtype)

    def forward(self, x: Tensor, phase: str = "train",
                return_sources: bool = False):
        y, _ = self.backbone(x.permute(0, 3, 1, 2))
        sources = [self.l2norm(y[3])] + list(y[4:4 + self.n - 1])
        return outputs(*self.head(sources), phase, sources, return_sources)
