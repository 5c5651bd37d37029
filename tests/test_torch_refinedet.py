"""RefineDet320 in the port against ``odtpu`` on the CPU: the four-output
full-width forward and the seeded init (tolerances in
tests/torch_family_parity.py), ``detect_refine`` on seeded ARM/ODM
outputs (equal rows, atol 1e-6, as the detect tests hold them), and the
eval step on the trained RefineDet320-ft checkpoint: the same classes
and ``dropped`` as ``odtpu``'s ``make_eval_step``, rows within 1e-5.
"""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.ops.detect import detect_refine as jdetect_refine
from odtpu.utils.checkpoint import load_variables_npz as jload_variables_npz

from odtpu_torch.ops.detect import _XFORM_CLIP, detect_refine
from odtpu_torch.utils.checkpoint import load_odtpu_npz, load_strict

import torch_family_parity as fp

# trained RefineDet320 (tests/synth.py images), 102 float16 tensors
REFINEDET_FT = osp.join(osp.dirname(__file__), "..", "history", "tests",
                        "refinedet_ft_r5", "refinedet_ft_r5_iter3000_f16.npz")
NAME = "refinedet320_vgg16_voc"


@pytest.fixture(scope="module")
def pair():
    return fp.build_pair(NAME)


def test_forward_matches_flax(pair):
    fp.check_dims_and_priors(pair)
    assert pair["dims"] == [(40, 40), (20, 20), (10, 10), (5, 5)]
    shapes = fp.check_forward(pair)
    assert shapes == [(1, 6375, 4), (1, 6375, 2), (1, 6375, 4),
                      (1, 6375, 21)]


def test_init_follows_odtpu(pair):
    assert fp.check_init(pair) >= 40
    sd = pair["model"].state_dict()
    assert not sd["arm_loc_0.conv.weight"].any()


def _arm_odm(priors, seed, batch=2, classes=21):
    """Seeded softmaxed ARM/ODM outputs over ``priors``; a tenth of the
    ARM log-scales lie past the clamp, and some anchors are background
    to the ARM with P > 0.99."""
    rng = np.random.RandomState(seed)
    P = priors.shape[0]
    arm_loc = (rng.randn(batch, P, 4) * 0.5).astype(np.float32)
    wild = rng.rand(batch, P) < 0.1
    arm_loc[..., 2:][wild] = rng.choice([-60.0, 60.0], (wild.sum(), 2))
    odm_loc = (rng.randn(batch, P, 4) * 0.5).astype(np.float32)

    def softmax(z):
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    arm_conf = softmax(rng.randn(batch, P, 2) * 4)
    odm_conf = softmax(rng.randn(batch, P, classes) * 2)
    return arm_loc, arm_conf, odm_loc, odm_conf


@pytest.mark.parametrize("compact", [True, False])
def test_detect_refine_matches_odtpu(pair, compact):
    priors = np.array(pair["jpriors"])
    outs = _arm_odm(priors, seed=int(compact))
    assert (np.abs(outs[0][..., 2:]) > _XFORM_CLIP / 0.2).any()
    assert (outs[1][..., 0] > 0.99).mean() > 0.1
    want = np.asarray(jdetect_refine(*map(jnp.asarray, outs),
                                     jnp.asarray(priors), (0.1, 0.2),
                                     compact=compact))
    got = detect_refine(*map(torch.from_numpy, outs),
                        torch.from_numpy(priors), (0.1, 0.2),
                        compact=compact).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (want[..., 0] > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_eval_step_on_refinedet_ft_weights_matches_odtpu(pair):
    if not osp.isfile(REFINEDET_FT):
        pytest.skip("the RefineDet320-ft checkpoint is not in this checkout")
    variables, loaded, skipped = jload_variables_npz(pair["variables"],
                                                     REFINEDET_FT)
    assert len(loaded) == 102 and not skipped
    load_strict(pair["model"], load_odtpu_npz(REFINEDET_FT, pair["model"]))
    fp.check_eval_step(pair, variables)
