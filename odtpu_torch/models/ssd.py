"""SSD detector head over a multi-scale backbone (VGG16 or a DRN).

Counterpart of ``odtpu/models/ssd.py``. The public boundary is NHWC, as
in ``odtpu``: the forward takes [B, H, W, 3] images and returns loc
[B, P, 4] and conf [B, P, C] in float32 (float64 in a float64 model).
Inside, the convs run NCHW.

Extras follow the reference's compact spec (ssd_v3.py:245-249):
alternating 1x1 / 3x3 convs, 'S' = stride-2 pad-1 on the following
feature count, a source captured after every second conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor, nn

from ..ops.detect import ssd_decode
from ..parallel import spatial
from .common import Conv, L2Norm, float32_or_wider

EXTRAS_SPEC = {
    "ssd300": [256, "S", 512, 128, "S", 256, 128, 256, 128, 256],
    "ssd512": [256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256,
               128, "S", 256],
}


def parse_extras(spec: Sequence):
    """Reference-style spec -> [(features, kernel, stride, padding), ...]."""
    layers = []
    flag = False  # False -> kernel 1, True -> kernel 3
    in_ch_is_s = False
    for k, v in enumerate(spec):
        if not in_ch_is_s:
            if v == "S":
                layers.append((spec[k + 1], 3 if flag else 1, 2, 1))
            else:
                layers.append((v, 3 if flag else 1, 1, 0))
            flag = not flag
        in_ch_is_s = v == "S"
    return layers


def flatten_head(x: Tensor, width: int) -> Tensor:
    """A head's NCHW output [B, A*width, H, W] -> [B, H*W*A, width], in
    the priors' order: cell-major, anchor-minor. Under a spatial plan
    the rows of every rank are gathered first
    (``parallel.spatial.gather_rows``), so that the order is global."""
    x = spatial.gather_rows(x)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class MultiBoxHead(nn.Module):
    """Per-source 3x3 loc/conf convs -> [B, P, 4] / [B, P, C] in float32
    (or wider). They stay in the compute dtype under int8 serving
    (``odtpu/models/ssd.py:71-79``).

    The prior order is cell-major, anchor-minor, which is the NHWC
    flatten of each head's output: ``permute(0, 2, 3, 1)`` comes before
    the reshape (reference ssd_v3.py:114-121).
    """

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 num_priors: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.num_classes = num_classes
        for i, (cin, a) in enumerate(zip(in_channels, num_priors)):
            self.add_module(f"loc_{i}", Conv(cin, a * 4, 3, padding=1,
                                             relu=False,
                                             init="xavier_uniform",
                                             dtype=dtype,
                                             quantizable=False))
            self.add_module(f"conf_{i}", Conv(cin, a * num_classes, 3,
                                              padding=1, relu=False,
                                              init="xavier_uniform",
                                              dtype=dtype,
                                              quantizable=False))

    def forward(self, sources: Sequence[Tensor]):
        locs, confs = [], []
        for i, src in enumerate(sources):
            locs.append(flatten_head(getattr(self, f"loc_{i}")(src), 4))
            confs.append(flatten_head(getattr(self, f"conf_{i}")(src),
                                      self.num_classes))
        return (float32_or_wider(torch.cat(locs, 1)),
                float32_or_wider(torch.cat(confs, 1)))


def outputs(loc: Tensor, conf: Tensor, phase: str, sources,
            return_sources: bool):
    """(loc, conf[, sources]), conf softmaxed (in float32) when ``phase ==
    "eval"`` (reference ssd_v3.py:123-127)."""
    if phase == "eval":
        conf = torch.softmax(conf, dim=-1)
    return (loc, conf, sources) if return_sources else (loc, conf)


def build_trunk(module: nn.Module, backbone: nn.Module, extras_spec,
                dtype: torch.dtype) -> list[int]:
    """Give ``module`` SSD's trunk (``backbone``, ``l2norm`` on the first
    tap, ``extras_<i>``); returns the channels of its sources."""
    module.backbone = backbone
    module.l2norm = L2Norm(backbone.out_channels[0], dtype=dtype)
    channels = list(backbone.out_channels)
    cin = backbone.final_channels
    module.n_extras = 0
    for i, (f, k, s, p) in enumerate(parse_extras(extras_spec)):
        module.add_module(f"extras_{i}", Conv(cin, f, k, stride=s,
                                              padding=p, dtype=dtype))
        if i % 2 == 1:
            channels.append(f)
        cin = f
        module.n_extras += 1
    return channels


def run_trunk(module: nn.Module, x: Tensor) -> list[Tensor]:
    """The NCHW sources of a module built by :func:`build_trunk`, from NHWC
    images."""
    sources, feat = module.backbone(x.permute(0, 3, 1, 2))
    sources = list(sources)
    sources[0] = module.l2norm(sources[0])
    for i in range(module.n_extras):
        feat = getattr(module, f"extras_{i}")(feat)
        if i % 2 == 1:  # a source after every second extra conv
            sources.append(feat)
    return sources


class SSD(nn.Module):
    """Single Shot MultiBox Detector.

    ``forward(x, phase)`` -> (loc [B,P,4], conf [B,P,C]); conf is
    softmaxed (in float32) when ``phase == "eval"``. With
    ``return_sources=True`` it also returns the NCHW source maps.
    """

    # (outputs, priors, variances) -> (decoded boxes, conf), which
    # the eval step's per-class NMS takes
    decode = staticmethod(ssd_decode)

    def __init__(self, backbone: nn.Module, num_classes: int,
                 num_priors: Sequence[int], extras_spec: Sequence,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        channels = build_trunk(self, backbone, extras_spec, dtype)
        self.head = MultiBoxHead(channels, num_classes, num_priors, dtype)

    def forward(self, x: Tensor, phase: str = "train",
                return_sources: bool = False):
        sources = run_trunk(self, x)
        return outputs(*self.head(sources), phase, sources, return_sources)
