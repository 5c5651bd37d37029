"""Seeded random weights of a configuration, made on the device.

The reference model (``benchmark.reference.build``) names every tensor
as the program's state dict does; this draws them all from one
``torch.Generator`` on ``device`` in three large calls (one normal draw
for every conv weight, one uniform draw for the heads, one normal draw
for the biases and the norms), then slices and scales. Each conv weight
follows its ``Conv.init``:

- ``he_normal``: normal, std sqrt(2 / fan_in);
- ``lecun_normal``: normal, std sqrt(1 / fan_in);
- ``xavier_uniform``: uniform +-sqrt(6 / (fan_in + fan_out)), times the
  configuration's ``head_gain`` (``assumed``);

with fan_in = in channels x kernel area and fan_out = out channels x
kernel area. The first conv, which sees raw pixels (std ~70), is divided
by ``assumed.first_conv_divisor``. Biases: normal, std ``bias_std``. A
batch norm: scale 1 + 0.1 n, bias 0.1 n, running mean 0.1 n, running
variance 0.5 + u (u uniform in [0, 1)). L2Norm scales: ``l2norm_scale``.
"""

from __future__ import annotations

import math

import torch

from .reference.common import BatchNorm, Conv


def make(model, cfg: dict, seed: int, device) -> dict:
    """{state-dict name: float32 tensor on ``device``}."""
    a = cfg["assumed"]
    convs = [(n, m) for n, m in model.named_modules() if isinstance(m, Conv)]
    norms = [(n, m) for n, m in model.named_modules()
             if isinstance(m, BatchNorm)]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))

    def numel(shape):
        return math.prod(shape)

    normal_w = [(n, m) for n, m in convs if m.init != "xavier_uniform"]
    heads = [(n, m) for n, m in convs if m.init == "xavier_uniform"]
    biases = [(n, m) for n, m in convs if m.conv.bias is not None]
    big_n = torch.randn(sum(m.conv.weight.numel() for _, m in normal_w),
                        generator=g, device=device)
    big_u = torch.rand(sum(m.conv.weight.numel() for _, m in heads),
                       generator=g, device=device)
    small = torch.randn(sum(m.conv.out_channels for _, m in biases)
                        + 4 * sum(m.weight.numel() for _, m in norms),
                        generator=g, device=device)
    out = {}
    first = convs[0][0]
    at = 0
    for name, m in normal_w:
        shape = m.conv.weight.shape
        fan_in = numel(shape[1:])
        std = math.sqrt((2.0 if m.init == "he_normal" else 1.0) / fan_in)
        if name == first:
            std /= float(a["first_conv_divisor"])
        out[name + ".conv.weight"] = (big_n[at:at + numel(shape)]
                                      .view(shape) * std)
        at += numel(shape)
    at = 0
    for name, m in heads:
        shape = m.conv.weight.shape
        fan_in, fan_out = numel(shape[1:]), shape[0] * numel(shape[2:])
        lim = math.sqrt(6.0 / (fan_in + fan_out)) * float(a["head_gain"])
        out[name + ".conv.weight"] = ((big_u[at:at + numel(shape)]
                                       .view(shape) * 2 - 1) * lim)
        at += numel(shape)
    at = 0
    for name, m in biases:
        c = m.conv.out_channels
        out[name + ".conv.bias"] = small[at:at + c] * float(a["bias_std"])
        at += c
    for name, m in norms:
        c = m.weight.numel()
        n = small[at:at + 4 * c].view(4, c)
        at += 4 * c
        out[name + ".weight"] = 1.0 + 0.1 * n[0]
        out[name + ".bias"] = 0.1 * n[1]
        out[name + ".running_mean"] = 0.1 * n[2]
        # 0.5 + u: u from the normal draw's cumulative distribution
        out[name + ".running_var"] = 0.5 + 0.5 * (
            1 + torch.erf(n[3] / math.sqrt(2.0)))
        out[name + ".num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
    for name, p in model.named_parameters():
        if name not in out:  # the L2Norm scales
            out[name] = torch.full(p.shape, float(a["l2norm_scale"]),
                                   device=device)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise KeyError("no rule for {}".format(sorted(missing)))
    return out
