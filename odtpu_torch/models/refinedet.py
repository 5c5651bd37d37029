"""RefineDet: two-step anchor refinement (ARM + TCB + ODM).

Counterpart of ``odtpu/models/refinedet.py`` (arXiv:1711.06897):

- ARM (anchor refinement): binary objectness and loc heads on the raw
  sources (conv4_3 after L2Norm 10, conv5_3 after L2Norm 8, conv7, one
  1x1(256) + 3x3/s2(512) extra stage). Its loc heads start at zero, so
  the refined anchors start as the priors.
- TCB (transfer connection blocks), top down: conv-relu-conv, plus the
  deeper TCB upsampled and convolved, relu, conv-relu.
- ODM (object detection): L2Norm (scale 20) on each TCB output, then the
  C-class and loc heads, which regress against the refined anchors
  (``ops.detect.detect_refine``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..ops.detect import refine_decode
from .common import Conv, L2Norm, float32_or_wider
from .fpn import upsample_bilinear
from .ssd import flatten_head


# the width of every TCB and of the ODM's inputs
TCB_DIM = 256


class TCB(nn.Module):
    """Transfer connection block of one pyramid level."""

    def __init__(self, in_ch: int, has_deeper: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dim = TCB_DIM
        self.conv1 = Conv(in_ch, dim, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(dim, dim, 3, padding=1, relu=False, dtype=dtype)
        self.up_conv = (Conv(dim, dim, 3, padding=1, relu=False, dtype=dtype)
                        if has_deeper else None)
        self.conv3 = Conv(dim, dim, 3, padding=1, dtype=dtype)

    def forward(self, x: Tensor, deeper: Tensor | None = None) -> Tensor:
        x = self.conv2(self.conv1(x))
        if deeper is not None:
            x = x + self.up_conv(upsample_bilinear(deeper, x.shape[2:]))
        return self.conv3(F.relu(x))


def _head(cin, width, init, dtype):
    """An ARM or ODM head conv, kept in the compute dtype under int8
    serving (``odtpu/models/refinedet.py:98-136``)."""
    return Conv(cin, width, 3, padding=1, relu=False, init=init,
                dtype=dtype, quantizable=False)


class RefineDet(nn.Module):
    """``forward(x, phase)`` -> (arm_loc [B,P,4], arm_conf [B,P,2],
    odm_loc [B,P,4], odm_conf [B,P,C]), float32 (or wider); the eval
    phase softmaxes both confs. ``backbone`` taps (conv4_3, conv5_3,
    conv7)."""

    # the two-step decode: (outputs, priors, variances) -> (boxes
    # decoded against the refined anchors, filtered conf)
    decode = staticmethod(refine_decode)

    def __init__(self, backbone: nn.Module, num_classes: int,
                 num_priors: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        c43, c53, c7 = backbone.out_channels
        self.extra_0 = Conv(backbone.final_channels, 256, 1, dtype=dtype)
        self.extra_1 = Conv(256, 512, 3, stride=2, padding=1, dtype=dtype)
        self.l2norm_4_3 = L2Norm(c43, scale_init=10.0, dtype=dtype)
        self.l2norm_5_3 = L2Norm(c53, scale_init=8.0, dtype=dtype)
        channels = [c43, c53, c7, 512]
        self.n = n = len(channels)
        for i, (cin, a) in enumerate(zip(channels, num_priors)):
            self.add_module(f"arm_loc_{i}", _head(cin, a * 4, "zeros", dtype))
            self.add_module(f"arm_conf_{i}",
                            _head(cin, a * 2, "xavier_uniform", dtype))
        for i, cin in enumerate(channels):
            self.add_module(f"tcb_{i}", TCB(cin, has_deeper=i < n - 1,
                                            dtype=dtype))
        for i, a in enumerate(num_priors):
            self.add_module(f"odm_norm_{i}", L2Norm(TCB_DIM, 20.0,
                                                    dtype=dtype))
            self.add_module(f"odm_loc_{i}",
                            _head(TCB_DIM, a * 4, "xavier_uniform", dtype))
            self.add_module(f"odm_conf_{i}",
                            _head(TCB_DIM, a * num_classes,
                                  "xavier_uniform", dtype))

    def _heads(self, name, sources, width):
        return float32_or_wider(torch.cat(
            [flatten_head(getattr(self, f"{name}_{i}")(s), width)
             for i, s in enumerate(sources)], 1))

    def forward(self, x: Tensor, phase: str = "train",
                return_sources: bool = False):
        (c43, c53, c7), feat = self.backbone(x.permute(0, 3, 1, 2))
        e = self.extra_1(self.extra_0(feat))
        sources = [self.l2norm_4_3(c43), self.l2norm_5_3(c53), c7, e]
        arm_loc = self._heads("arm_loc", sources, 4)
        arm_conf = self._heads("arm_conf", sources, 2)
        tcb, deeper = [None] * self.n, None
        for i in reversed(range(self.n)):
            deeper = tcb[i] = getattr(self, f"tcb_{i}")(sources[i], deeper)
        normed = [getattr(self, f"odm_norm_{i}")(t) for i, t in
                  enumerate(tcb)]
        odm_loc = self._heads("odm_loc", normed, 4)
        odm_conf = self._heads("odm_conf", normed, self.num_classes)
        if phase == "eval":
            arm_conf = torch.softmax(arm_conf, dim=-1)
            odm_conf = torch.softmax(odm_conf, dim=-1)
        out = (arm_loc, arm_conf, odm_loc, odm_conf)
        return out + (sources,) if return_sources else out


def refinedet320_cfg(cfg):
    """Overlay the RefineDet320 anchor spec onto a config tree."""
    cfg.DATASET.IMAGE_SIZE = (320, 320)
    cfg.MODEL.IMAGE_SIZE = (320, 320)
    cfg.MODEL.SSD_TYPE = "RefineDet"
    cfg.MODEL.STEPS = [8, 16, 32, 64]
    cfg.MODEL.MIN_SIZES = [32, 64, 128, 256]
    cfg.MODEL.MAX_SIZES = []
    cfg.MODEL.ASPECT_RATIOS = [[2], [2], [2], [2]]
    return cfg
