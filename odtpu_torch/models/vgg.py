"""VGG16 'reduced fc' backbone, the SSD base network.

Counterpart of ``odtpu/models/vgg.py``: ceil-mode pool3, pool5 3x3/s1/p1,
dilated conv6 (k3, p6, d6), conv7 1x1. The forward returns the post-ReLU
activations at ``taps`` (conv4_3 and conv7, the two base-net SSD
sources; RefineDet taps conv5_3 too) and the conv7 output that feeds the
extras. ``batch_norm`` puts a norm after every conv (VGG16-BN,
``MODEL.BATCH_NORM``). ``pool5_stride2`` is RefineDet's variant: a 2x2/s2
pool5 and conv6 with dilation 3, so conv7 sits at stride 32.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv, max_pool_ceil

# (name, in, out) of the 3x3/p1 convs; "pool" / "pool_ceil" between blocks
_LAYERS = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    "pool_ceil",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    "pool",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]


class VGG16(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 taps: tuple = ("conv4_3", "conv7"),
                 batch_norm: bool = False, pool5_stride2: bool = False):
        super().__init__()
        self.taps = taps
        self.pool5_stride2 = pool5_stride2
        for layer in _LAYERS:
            if isinstance(layer, tuple):
                name, cin, cout = layer
                self.add_module(name, Conv(cin, cout, 3, padding=1,
                                           batch_norm=batch_norm,
                                           dtype=dtype))
        d = 3 if pool5_stride2 else 6
        self.conv6 = Conv(512, 1024, 3, padding=d, dilation=d,
                          batch_norm=batch_norm, dtype=dtype)
        self.conv7 = Conv(1024, 1024, 1, batch_norm=batch_norm, dtype=dtype)
        self.out_channels = [getattr(self, t).conv.out_channels
                             for t in taps]
        self.final_channels = self.conv7.conv.out_channels

    def forward(self, x):
        acts = {}
        for layer in _LAYERS:
            if layer == "pool":
                x = max_pool_ceil(x, 2, 2)
            elif layer == "pool_ceil":
                x = max_pool_ceil(x, 2, 2, ceil_mode=True)  # 75 -> 38
            else:
                x = getattr(self, layer[0])(x)
                acts[layer[0]] = x
        if self.pool5_stride2:
            x = max_pool_ceil(x, 2, 2)
        else:
            x = max_pool_ceil(x, 3, 1, padding=1)  # pool5 keeps the dims
        x = self.conv6(x)
        x = self.conv7(x)
        acts["conv7"] = x
        return [acts[t] for t in self.taps], x
