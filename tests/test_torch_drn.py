"""The DRN bases in the port against ``odtpu`` on the CPU: SSD300 over
DRN-D-22 and DRN-D-24 and DRN_SSD (heads on DRN-D-22's middle stages),
full-width forward and seeded init (tolerances in
tests/torch_family_parity.py), and the Bottleneck block, which no plan
of the zoo uses, at a small width (float32, within 1e-5 of its largest
output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.models.drn import Bottleneck as JBottleneck

from odtpu_torch.models.drn import Bottleneck
from odtpu_torch.utils.checkpoint import from_odtpu_params, load_strict

import torch_family_parity as fp

NAMES = ["ssd_drn22_voc", "ssd_drn24_voc", "drnssd_drn22_voc"]


@pytest.fixture(scope="module")
def pairs():
    return fp.Pairs()


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_flax(pairs, name):
    fp.check_dims_and_priors(pairs(name))
    fp.check_forward(pairs(name))


@pytest.mark.parametrize("name", NAMES)
def test_init_follows_odtpu(pairs, name):
    assert fp.check_init(pairs(name)) >= 40


@pytest.mark.parametrize("stride,dilation,in_ch", [(1, (1, 1), 32),
                                                   (2, (1, 2), 16)])
def test_bottleneck_matches_flax(stride, dilation, in_ch):
    """With random batch statistics, so the norm is not the identity."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 9, 9, in_ch).astype(np.float32)
    jblock = JBottleneck(8, stride=stride, dilation=dilation,
                         dtype=jnp.float32)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = fp.flat_variables(variables)
    for key in flat:
        if key.startswith("__batch_stats__/"):
            flat[key] = rng.uniform(0.5, 1.5, flat[key].shape).astype(
                np.float32) - key.endswith("mean")
    want = np.asarray(jblock.apply(
        {"params": variables["params"], "batch_stats": {
            k: {"bn": {"mean": flat["__batch_stats__/{}/bn/mean".format(k)],
                       "var": flat["__batch_stats__/{}/bn/var".format(k)]}}
            for k in variables["batch_stats"]}},
        jnp.asarray(x)))
    block = Bottleneck(in_ch, 8, stride=stride, dilation=dilation,
                       dtype=torch.float32).eval()
    load_strict(block, from_odtpu_params(flat, block))
    assert (block.down is not None) == (in_ch != 32 or stride != 1)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
