"""Building blocks of the reference models, in plain float32 PyTorch.

Tensors are NCHW inside a model; a model takes NHWC images. Every conv
goes through :class:`Conv`, whose parameters are named as the program's
state dict names them (``<name>.conv.weight``, ``<name>.conv.bias``,
``<name>.bn.weight`` ...), so that the benchmark hands one dict of
tensors to both. ``Conv.init`` names the distribution the benchmark
draws the weight from (``benchmark.weights``).

``lowp``: every conv takes an optional function applied to its input and
to its weight, the lower-precision control (:func:`fp8_fake_quant`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn


class _FakeQuant(torch.autograd.Function):
    """Rounding to float8 e4m3 with one scale per ``dims`` slice (its
    largest magnitude onto e4m3's largest, 448), and a straight-through
    backward in float32."""

    @staticmethod
    def forward(ctx, x, dims):
        amax = x.detach().abs().amax(dim=dims, keepdim=True)
        scale = torch.where(amax > 0, amax / 448.0, 1.0)
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def fp8_fake_quant(x: Tensor, weight: bool) -> Tensor:
    """float8 e4m3 with one scale a tensor for an activation and one an
    output channel for a weight."""
    dims = tuple(range(1, x.dim())) if weight else tuple(range(x.dim()))
    return _FakeQuant.apply(x, dims)


class BatchNorm(nn.Module):
    """Batch norm's parameters and buffers, as ``nn.BatchNorm2d`` names
    them. Eval mode: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.
    Train mode: the batch's mean and biased variance over (N, H, W) in
    the same formula (the running statistics are not followed)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        if train:
            mean = x.mean((0, 2, 3), keepdim=True)
            var = (x - mean).square().mean((0, 2, 3), keepdim=True)
        else:
            mean = self.running_mean[None, :, None, None]
            var = self.running_var[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight[None, :, None, None]
        return (x - mean) * mul + self.bias[None, :, None, None]


class Conv(nn.Module):
    """conv (bias unless batch norm) -> optional batch norm -> optional
    ReLU."""

    def __init__(self, cin: int, cout: int, kernel=3, stride: int = 1,
                 padding=0, dilation: int = 1, relu: bool = True,
                 bn: bool = False, init: str = "he_normal"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, dilation=dilation,
                              bias=not bn)
        self.bn = BatchNorm(cout) if bn else None
        self.relu = relu
        self.init = init

    def forward(self, x: Tensor, ctx) -> Tensor:
        c = self.conv
        w = c.weight
        if ctx.lowp is not None:
            x, w = ctx.lowp(x, False), ctx.lowp(w, True)
        x = F.conv2d(x, w, c.bias, c.stride, c.padding, c.dilation)
        if self.bn is not None:
            x = self.bn(x, ctx.train)
        return F.relu(x) if self.relu else x


class Ctx:
    """What a forward needs besides its input: train-mode norms, and the
    lower-precision rounding of the control (None for float32)."""

    def __init__(self, train: bool = False, lowp=None):
        self.train = train
        self.lowp = lowp


def l2norm(x: Tensor, scale: Tensor, eps: float = 1e-10) -> Tensor:
    """Channelwise L2 normalisation with eps after the sqrt, times a
    learned scale a channel."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps
    return x / norm * scale[None, :, None, None]


def flatten_head(x: Tensor, width: int) -> Tensor:
    """NCHW [B, A*width, H, W] -> [B, H*W*A, width]: cell-major,
    anchor-minor, the priors' order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class Heads(nn.Module):
    """``loc_<i>`` and ``conf_<i>``: 3x3 convs over each source."""

    def __init__(self, channels, anchors, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        for i, (cin, a) in enumerate(zip(channels, anchors)):
            self.add_module(f"loc_{i}", Conv(cin, a * 4, 3, padding=1,
                                             relu=False,
                                             init="xavier_uniform"))
            self.add_module(f"conf_{i}", Conv(cin, a * num_classes, 3,
                                              padding=1, relu=False,
                                              init="xavier_uniform"))

    def forward(self, sources, ctx):
        locs = [flatten_head(getattr(self, f"loc_{i}")(s, ctx), 4)
                for i, s in enumerate(sources)]
        confs = [flatten_head(getattr(self, f"conf_{i}")(s, ctx),
                              self.num_classes)
                 for i, s in enumerate(sources)]
        return torch.cat(locs, 1), torch.cat(confs, 1)


# VGG16 with the reduced fc: (name, in, out) of the 3x3 pad-1 convs,
# "pool" (2x2 s2) and "pool_ceil" (2x2 s2, ceil mode: 75 -> 38)
VGG_LAYERS = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    "pool_ceil",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    "pool",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]


class VGG16(nn.Module):
    """conv1_1 .. conv5_3, pool5 (3x3 s1 p1), conv6 (3x3, dilation 6),
    conv7 (1x1); returns (conv4_3, conv7), both after their ReLU."""

    def __init__(self):
        super().__init__()
        for layer in VGG_LAYERS:
            if isinstance(layer, tuple):
                name, cin, cout = layer
                self.add_module(name, Conv(cin, cout, 3, padding=1))
        self.conv6 = Conv(512, 1024, 3, padding=6, dilation=6)
        self.conv7 = Conv(1024, 1024, 1)

    def forward(self, x, ctx):
        conv4_3 = None
        for layer in VGG_LAYERS:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
            elif layer == "pool_ceil":
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            else:
                x = getattr(self, layer[0])(x, ctx)
                if layer[0] == "conv4_3":
                    conv4_3 = x
        x = F.max_pool2d(x, 3, 1, padding=1)
        x = self.conv7(self.conv6(x, ctx), ctx)
        return conv4_3, x


def priors(cfg: dict, layer_dims) -> Tensor:
    """SSD's center-size priors [P, 4] in float32, cell-major and
    anchor-minor: per cell the min size, sqrt(min * max), then each
    aspect ratio r as (w * sqrt(r), h / sqrt(r)) and, with ``flip``, its
    inverse; clamped to [0, 1] when ``clip``."""
    img_h, img_w = cfg["image_size"]
    out = []
    for k, (fh, fw) in enumerate(layer_dims):
        step = cfg["steps"][k]
        s_w, s_h = cfg["min_sizes"][k] / img_w, cfg["min_sizes"][k] / img_h
        cell = [(s_w, s_h)]
        mx = cfg["max_sizes"][k]
        cell.append((math.sqrt(s_w * (mx / img_w)),
                     math.sqrt(s_h * (mx / img_h))))
        for ar in cfg["aspect_ratios"][k]:
            r = math.sqrt(ar)
            cell.append((s_w * r, s_h / r))
            if cfg["flip"]:
                cell.append((s_w / r, s_h * r))
        for i in range(fh):
            for j in range(fw):
                cx = (j + 0.5) / (img_w / step)
                cy = (i + 0.5) / (img_h / step)
                out.extend((cx, cy, w, h) for w, h in cell)
    p = torch.tensor(out, dtype=torch.float64)
    if cfg["clip"]:
        p = p.clamp(0.0, 1.0)
    return p.float()


def anchors_per_cell(cfg: dict) -> list[int]:
    """Priors a cell of each source map holds."""
    return [2 + len(a) * (2 if cfg["flip"] else 1)
            for a in cfg["aspect_ratios"]]


def point_form(boxes: Tensor) -> Tensor:
    return torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                      boxes[..., :2] + boxes[..., 2:] / 2], -1)


def overlaps(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Pairwise intersection and union of point-form boxes [..., A, 4] x
    [..., B, 4]: areas unclamped, the intersection clamped at 0."""
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp(min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter, area_a[..., :, None] + area_b[..., None, :] - inter


def iou(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise IoU of point-form boxes [..., A, 4] x [..., B, 4]."""
    inter, union = overlaps(a, b)
    return inter / union


def decode(loc: Tensor, pri: Tensor, variances) -> Tensor:
    """Regression [..., P, 4] against center-size priors -> point form."""
    cxcy = pri[..., :2] + loc[..., :2] * variances[0] * pri[..., 2:]
    wh = pri[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = cxcy - wh / 2
    return torch.cat([mins, mins + wh], -1)


def encode(matched: Tensor, pri: Tensor, variances) -> Tensor:
    """Point-form boxes matched to center-size priors -> targets."""
    cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - pri[..., :2]
    cxcy = cxcy / (variances[0] * pri[..., 2:])
    wh = (matched[..., 2:] - matched[..., :2]) / pri[..., 2:]
    wh = torch.log(wh + 1e-10) / variances[1]
    return torch.cat([cxcy, wh], -1)
