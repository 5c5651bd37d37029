"""Batch norm in train mode, the port against flax on the CPU.

The port's ``Conv(batch_norm=True)`` (torch momentum 0.1, ``odtpu``'s
``Conv`` at flax's 0.9), RFBNet's ``BasicConv`` (0.01, flax's 0.99) and a
bare norm through ``common.batch_norm`` (FSSD's ``fusion_bn``, flax's
``nn.BatchNorm(momentum=0.9)``) take two train-mode steps on seeded
inputs, beside flax's ``use_running_average=False`` on the same weights.
Held each step: the output, the gradients of a seeded linear function of
it with respect to the input, the norm's scale and bias (and the conv
kernel), against ``jax.grad``; and the running mean and variance after
the step. Maps of 2 x 5x5 values a channel, 2 x 1x1 (n = 2: the biased
variance is half the unbiased one) and 1 x 1x1 (one value a channel,
where the output is the bias).

Tolerances: float32 on both sides, statistics over at most 50 values a
channel; outputs and the scale and bias gradients within 1e-5 of their
largest value, running statistics within rtol 1e-5, atol 1e-6 (the two
frameworks reduce in another order). Flax takes the variance as E[x^2]
- E[x]^2, a few float32 ulps of E[x^2] off, which is c = E[x^2] / (Var +
eps) times more in relative terms of Var + eps: where 4 c ulps pass
1e-5 (n > 1 only: one value gives a variance of exactly 0 on both
sides), they replace 1e-5 in every comparison. The input and kernel
gradients are held within that of the largest gradient the same function has with the batch statistics
held fixed: train mode subtracts the statistics' share from it, and at
n = 2, where the normalised values are +-1 whatever x is, that share
cancels it to rounding noise (~1e-5 of the fixed-statistics gradient).
"""

import copy
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from odtpu.models import common as jcommon
from odtpu.models import rfbnet as jrfbnet

from odtpu_torch.models import common
from odtpu_torch.models.rfbnet import BasicConv

torch.set_num_threads(2)

CIN, COUT = 3, 4
SHAPES = [(2, 5, 5), (2, 1, 1), (1, 1, 1)]


class _FlaxNorm(fnn.Module):
    """FSSD's fusion norm as ``odtpu`` writes it (fssd.py:74)."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, dtype=jnp.float32,
                             name="bn")(x)


class _TorchNorm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return common.batch_norm(self.bn, x, torch.float32)


def _pair(kind):
    """(torch module, flax module, torch momentum) of one kind."""
    if kind == "conv":
        return (common.Conv(CIN, COUT, 3, padding=1, relu=False,
                            batch_norm=True, dtype=torch.float32),
                jcommon.Conv(COUT, kernel=3, padding=1, relu=False,
                             batch_norm=True, dtype=jnp.float32), 0.1)
    if kind == "basic_conv":
        return (BasicConv(CIN, COUT, 3, padding=1, relu=False,
                          dtype=torch.float32),
                jrfbnet.BasicConv(COUT, kernel=3, padding=1, relu=False,
                                  dtype=jnp.float32), 0.01)
    return _TorchNorm(CIN), _FlaxNorm(), 0.1


def _variables(kind, rng):
    """Seeded flax variables: a conv kernel, and a norm not at its
    identity (scale 0.5..1.5, bias and mean +-0.5, variance 0.5..1.5)."""
    width = CIN if kind == "fusion_bn" else COUT
    bn = {"scale": rng.uniform(0.5, 1.5, width),
          "bias": rng.uniform(-0.5, 0.5, width)}
    stats = {"mean": rng.uniform(-0.5, 0.5, width),
             "var": rng.uniform(0.5, 1.5, width)}
    params = {"bn": bn}
    if kind != "fusion_bn":
        params["conv"] = {"kernel": rng.randn(3, 3, CIN, COUT) * 0.3}
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
    return cast(params), cast({"bn": stats})


def _load(module, params, stats):
    with torch.no_grad():
        if "conv" in params:
            module.conv.weight.copy_(torch.from_numpy(np.asarray(
                params["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        bn = module.bn
        for buf, value in ((bn.weight, params["bn"]["scale"]),
                           (bn.bias, params["bn"]["bias"]),
                           (bn.running_mean, stats["bn"]["mean"]),
                           (bn.running_var, stats["bn"]["var"])):
            buf.copy_(torch.from_numpy(np.array(value)))


def _close(got, want, what, rtol, scale=None):
    want = np.asarray(want)
    if scale is None:
        scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(scale, 1e-30), err_msg=what)


def _cancellation(module, xt):
    """4 float32 ulps times the largest E[x^2] / (Var + eps) over the
    channels of the norm's input: the relative error that flax's E[x^2] -
    E[x]^2 leaves in Var + eps."""
    seen = []
    hook = module.bn.register_forward_pre_hook(
        lambda bn, args: seen.append(args[0].detach().double()))
    with torch.no_grad():
        module.eval()(xt)
    module.train()
    hook.remove()
    x = seen[0]
    if x.numel() == x.shape[1]:
        return 0.0
    var = x.var((0, 2, 3), unbiased=False)
    ratio = (x.square().mean((0, 2, 3)) / (var + module.bn.eps)).max()
    return 4 * 2.0 ** -24 * float(ratio)


def _fixed_stats_grads(module, xt, gt):
    """The largest input (and kernel) gradient of sum(module(x) * g) with
    the norm's statistics fixed at this batch's: the norm in eval mode,
    its running statistics set from its input."""
    frozen = copy.deepcopy(module).eval()

    def set_stats(bn, args):
        var, mean = torch.var_mean(args[0].detach(), (0, 2, 3),
                                   correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    frozen.bn.register_forward_pre_hook(set_stats)
    x = xt.detach().clone().requires_grad_(True)
    (frozen(x) * gt).sum().backward()
    kernel = (frozen.conv.weight.grad.abs().max().item()
              if hasattr(frozen, "conv") else None)
    return x.grad.abs().max().item(), kernel


@pytest.mark.parametrize("shape", SHAPES, ids=["2x5x5", "2x1x1", "1x1x1"])
@pytest.mark.parametrize("kind", ["conv", "basic_conv", "fusion_bn"])
def test_train_mode_matches_flax(kind, shape):
    rng = np.random.RandomState(zlib.crc32("{}{}".format(kind, shape)
                                           .encode()))
    module, jmodule, momentum = _pair(kind)
    params, stats = _variables(kind, rng)
    _load(module, params, stats)
    module.train()
    assert module.bn.momentum == momentum
    B, H, W = shape
    cout = CIN if kind == "fusion_bn" else COUT
    for step in range(2):
        # a mean of 3 and a spread of 2: the statistics are not init's
        x = (3 + 2 * rng.randn(B, H, W, CIN)).astype(np.float32)
        g = rng.randn(B, H, W, cout).astype(np.float32)

        def loss(p, xj):
            y, mut = jmodule.apply({"params": p, "batch_stats": stats}, xj,
                                   train=True, mutable=["batch_stats"])
            return jnp.sum(y * g), (y, mut["batch_stats"])

        (_, (want, stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy())
        dx_scale, dk_scale = _fixed_stats_grads(module, xt, gt)
        rtol = max(1e-5, _cancellation(module, xt))
        xt.requires_grad_(True)
        for p in module.parameters():
            p.grad = None
        y = module(xt)
        (y * gt).sum().backward()
        what = "{} step {}".format(kind, step)
        _close(y.detach().numpy().transpose(0, 2, 3, 1), want,
               what + " output", rtol)
        if B * H * W == 1:  # the output is the bias: no input gradient
            assert not np.asarray(gx).any()
            np.testing.assert_array_equal(
                y.detach().numpy().ravel(),
                np.asarray(params["bn"]["bias"]))
        _close(xt.grad.numpy().transpose(0, 2, 3, 1), gx, what + " dx", rtol,
               dx_scale)
        _close(module.bn.weight.grad.numpy(), gp["bn"]["scale"],
               what + " dscale", rtol)
        _close(module.bn.bias.grad.numpy(), gp["bn"]["bias"],
               what + " dbias", rtol)
        if "conv" in params:
            _close(module.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
                   gp["conv"]["kernel"], what + " dkernel", rtol,
                   dk_scale)
        for leaf, buf in (("mean", module.bn.running_mean),
                          ("var", module.bn.running_var)):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(stats["bn"][leaf]),
                rtol=rtol, atol=1e-6,
                err_msg="{} running {}".format(what, leaf))


def test_stock_batchnorm2d_misses_flax_running_variance():
    """What ``nn.BatchNorm2d`` as it is would do: at n = B x H x W = 2 its
    running variance takes the unbiased batch variance, twice flax's, and
    at n = 1 it refuses the batch. The port's norm holds flax's update."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((3 + 2 * rng.randn(2, CIN, 1, 1)).astype(np.float32))
    batch_var = x.var((0, 2, 3), unbiased=False)
    stock = nn.BatchNorm2d(CIN, momentum=0.1).train()
    stock(x)
    ours = _TorchNorm(CIN).train()
    ours(x)
    flax_var = 0.9 * 1.0 + 0.1 * batch_var
    torch.testing.assert_close(ours.bn.running_var, flax_var)
    # the stock update's batch term is n / (n - 1) = 2 times flax's
    torch.testing.assert_close(stock.running_var - 0.9, 2 * (flax_var - 0.9))
    assert ((stock.running_var - flax_var).abs() > 0.05 * batch_var).all()
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        stock(x[:1])
    # one value a channel: flax's variance is 0, so the running one decays
    before = ours.bn.running_var.clone()
    ours(x[:1])
    torch.testing.assert_close(ours.bn.running_var, 0.9 * before)
