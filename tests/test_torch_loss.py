"""The port's box math, matching, multibox loss, unsorted NMS mask and
on-device photometric augmentation against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides as numpy.
Tolerances, and why:
- area, intersect, jaccard, encode, log_sum_exp: rtol 1e-6 (log and
  exp in XLA and in torch may differ by an ulp);
- matching: conf targets and matched GT indices equal, loc targets atol
  1e-5 (an ulp of the largest targets, ~100, is 8e-6);
- the mined loss: the positive and mined-negative masks equal on logits
  whose CE values are distinct, the sums within rtol 1e-5 (sums of
  ~10^4 terms taken in another order), num_pos equal; with ignored
  priors too;
- RefineDet's loss: num_pos equal, the four sums within rtol 1e-5 and
  the gradients of their total within 1e-5 of each input's largest
  (the same sums, and exp/log of the refined anchors an ulp apart);
- the photometric distortion fed odtpu's own draws: atol 1e-3 on the
  0-255 scale (the HSV round trip divides and takes remainders);
- the unsorted NMS mask: equal (pure selection on the same arithmetic).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.data import device_aug as jaug
from odtpu.layers import losses as jlosses
from odtpu.ops import boxes as jboxes
from odtpu.ops import matching as jmatching
from odtpu.ops.priors import PriorBoxSSD as JPriorBoxSSD
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch.data import device_aug
from odtpu_torch.layers import losses
from odtpu_torch.ops import boxes, matching, nms
from odtpu_torch.utils.config import default_cfg

from test_reference_goldens import GOLDEN as BOX_GOLDEN

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)

jnms = importlib.import_module("odtpu.ops.nms")

VARS = (0.1, 0.2)
SSD300_DIMS = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(scope="module")
def priors():
    return np.asarray(JPriorBoxSSD(jdefault_cfg())(SSD300_DIMS), np.float32)


def _point_boxes(rng, *shape):
    xy = rng.uniform(0.0, 0.7, shape + (2,))
    wh = rng.uniform(0.02, 0.5, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_math_matches_odtpu(rng):
    a = _point_boxes(rng, 3, 7)
    b = _point_boxes(rng, 3, 11)
    b[0, 0] = [0.5, 0.5, 0.4, 0.6]  # a negative extent
    for name in ("intersect", "jaccard"):
        got = getattr(boxes, name)(_t(a), _t(b)).numpy()
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(a),
                                                jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(boxes.area(_t(b)).numpy(),
                               np.asarray(jboxes.area(jnp.asarray(b))),
                               rtol=1e-6, atol=0)
    priors = np.concatenate([rng.uniform(0.1, 0.9, (3, 7, 2)),
                             rng.uniform(0.05, 0.6, (3, 7, 2))],
                            -1).astype(np.float32)
    a[1, 2, 2:] = a[1, 2, :2]  # a degenerate GT: the log eps quirk
    np.testing.assert_allclose(
        boxes.encode(_t(a), _t(priors), VARS).numpy(),
        np.asarray(jboxes.encode(jnp.asarray(a), jnp.asarray(priors), VARS)),
        rtol=1e-6, atol=0)
    x = rng.randn(4, 9, 21).astype(np.float32) * 5
    np.testing.assert_allclose(
        boxes.log_sum_exp(_t(x)).numpy(),
        np.asarray(jboxes.log_sum_exp(jnp.asarray(x))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scene", [0, 1])
def test_encode_and_match_hold_reference_golden(scene):
    g = np.load(BOX_GOLDEN)
    np.testing.assert_allclose(
        boxes.encode(_t(g["gt"]), _t(g["priors"]), VARS).numpy(), g["enc"],
        rtol=1e-5, atol=1e-6)
    loc_t, conf_t, _ = matching.match(
        _t(g["m%d_truths" % scene]), _t(g["m%d_labels" % scene]),
        _t(g["priors"]), VARS, 0.5)
    np.testing.assert_array_equal(conf_t.numpy(), g["m%d_conf_t" % scene])
    np.testing.assert_allclose(loc_t.numpy(), g["m%d_loc_t" % scene],
                               rtol=1e-4, atol=1e-5)


def _gt_batch(rng):
    """[4, 8] padded GT: random boxes, padding (label -1) at the end and in
    the middle, two identical GTs (their best prior collides: the later
    wins), a GT too small for any prior to reach 0.5, and an image with
    no GT at all."""
    B, G = 4, 8
    gt = _point_boxes(rng, B, G)
    labels = rng.randint(0, 20, (B, G))
    labels[0, 5:] = -1
    labels[1, 2] = -1
    gt[1, 4] = gt[1, 3]
    labels[1, 3], labels[1, 4] = 7, 11
    gt[2, 0] = [0.40, 0.40, 0.405, 0.406]
    labels[3] = -1
    return gt, labels


def test_match_batch_matches_odtpu(rng, priors):
    gt, labels = _gt_batch(rng)
    loc_t, conf_t, idx = matching.match_batch(_t(gt), _t(labels),
                                              _t(priors), VARS, 0.5)
    jloc, jconf, jidx = jmatching.match_batch(
        jnp.asarray(gt), jnp.asarray(labels, jnp.int32),
        jnp.asarray(priors), VARS, 0.5)
    np.testing.assert_array_equal(conf_t.numpy(), np.asarray(jconf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(jloc), rtol=0,
                               atol=1e-5)
    # the collision: GT 4 (label 11) holds the shared best prior
    best = int(np.argmax(np.asarray(
        jboxes.jaccard(jnp.asarray(gt[1, 3:4]),
                       jnp.asarray(np.concatenate(
                           [priors[:, :2] - priors[:, 2:] / 2,
                            priors[:, :2] + priors[:, 2:] / 2], 1))))[0]))
    assert int(conf_t[1, best]) == 12 and int(idx[1, best]) == 4
    # the tiny GT is still matched, by force, to exactly one prior
    assert int((idx[2] == 0).logical_and(conf_t[2] > 0).sum()) == 1
    assert int(conf_t[3].sum()) == 0


def _jax_masks(loc, conf, loc_t, conf_t):
    """odtpu's positive and mined masks: a prior is in the CE sum exactly
    when its logits get a gradient (softmax - onehot is never all 0)."""
    grad = jax.grad(lambda c: jlosses.mined_multibox(
        jnp.asarray(loc), c, jnp.asarray(loc_t),
        jnp.asarray(conf_t)).loss_conf_sum)(jnp.asarray(conf))
    return np.asarray(conf_t) > 0, np.abs(np.asarray(grad)).sum(-1) > 0


def test_multibox_loss_matches_odtpu(rng, priors):
    gt, labels = _gt_batch(rng)
    B, P = gt.shape[0], priors.shape[0]
    loc = (rng.randn(B, P, 4) * 0.5).astype(np.float32)
    conf = (rng.randn(B, P, 21) * 2).astype(np.float32)
    got = losses.multibox_loss(_t(loc), _t(conf), _t(priors), _t(gt),
                               _t(labels), VARS, 0.5, 3)
    want = jlosses.multibox_loss(jnp.asarray(loc), jnp.asarray(conf),
                                 jnp.asarray(priors), jnp.asarray(gt),
                                 jnp.asarray(labels, jnp.int32), VARS, 0.5, 3)
    assert int(got.num_pos) == int(want.num_pos) > 0
    for a, b in ((got.loss_loc_sum, want.loss_loc_sum),
                 (got.loss_conf_sum, want.loss_conf_sum)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    cls = losses.MultiBoxLoss(default_cfg())(
        (_t(loc), _t(conf), _t(priors)), (_t(gt), _t(labels)))
    jcls = jlosses.MultiBoxLoss(jdefault_cfg())(
        (jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors)),
        (jnp.asarray(gt), jnp.asarray(labels, jnp.int32)))
    np.testing.assert_allclose([float(v) for v in cls],
                               [float(v) for v in jcls], rtol=1e-5)


@pytest.mark.parametrize("n_pos", [0, 3, 20])
def test_mined_masks_and_sums_match_odtpu(rng, n_pos):
    """P = 50 priors, so that 3 * 20 positives clip num_neg at P - 1."""
    B, P, C = 3, 50, 21
    loc = rng.randn(B, P, 4).astype(np.float32)
    loc_t = rng.randn(B, P, 4).astype(np.float32)
    conf = (rng.randn(B, P, C) * 3).astype(np.float32)
    conf_t = np.zeros((B, P), np.int64)
    for b in range(B):
        conf_t[b, rng.permutation(P)[:n_pos + b]] = rng.randint(
            1, C, n_pos + b)
    got = losses.mined_multibox(_t(loc), _t(conf), _t(loc_t), _t(conf_t))
    want = jlosses.mined_multibox(jnp.asarray(loc), jnp.asarray(conf),
                                  jnp.asarray(loc_t),
                                  jnp.asarray(conf_t, jnp.int32))
    assert int(got.num_pos) == int(want.num_pos)
    np.testing.assert_allclose(float(got.loss_loc_sum),
                               float(want.loss_loc_sum), rtol=1e-5)
    np.testing.assert_allclose(float(got.loss_conf_sum),
                               float(want.loss_conf_sum), rtol=1e-5)

    logits = _t(conf)
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.clamp(_t(conf_t), min=0)[..., None])[..., 0]
    assert len(torch.unique(ce)) == ce.numel()  # distinct CE values
    pos, neg = losses.mining_masks(ce, _t(conf_t))
    jpos, jused = _jax_masks(loc, conf, loc_t, conf_t)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal((pos | neg).numpy(), jused)
    num_neg = np.minimum(3 * conf_t.astype(bool).sum(1), P - 1)
    np.testing.assert_array_equal(
        neg.sum(1).numpy(), np.minimum(num_neg, P - (conf_t > 0).sum(1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unsorted_nms_mask_matches_odtpu_with_ties(seed):
    rng = np.random.RandomState(seed)
    n = 60
    b = _point_boxes(rng, n) * 0.5 + 0.2
    scores = rng.choice([0.0, 0.005, 0.3, 0.3, 0.7, 0.9], n).astype(
        np.float32)
    got = nms.nms_mask(_t(b), _t(scores), 0.45, 0.01)
    want = jnms.nms_mask(jnp.asarray(b), jnp.asarray(scores), 0.45, 0.01)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
    # leading batch dims: each set as it is alone
    many = nms.nms_mask(_t(np.stack([b, b[::-1]])),
                        _t(np.stack([scores, scores[::-1]])), 0.45, 0.01)
    np.testing.assert_array_equal(many[0].numpy(), got.numpy())
    np.testing.assert_array_equal(
        many[1].numpy(), np.asarray(jnms.nms_mask(
            jnp.asarray(b[::-1]), jnp.asarray(scores[::-1]), 0.45, 0.01)))


def jax_draws(rng, batch):
    """odtpu's per-image photometric draws from ``rng``, in the order and
    from the keys ``photometric_distort_device`` uses, as the port's
    parameter dict."""
    out = {k: [] for k in device_aug.PARAMS}
    for key in jax.random.split(rng, batch):
        ks = jax.random.split(key, 11)
        u = jax.random.uniform
        bern = jax.random.bernoulli
        out["do_brightness"].append(bern(ks[0]))
        out["delta"].append(u(ks[1], (), minval=-32.0, maxval=32.0))
        out["contrast_first"].append(bern(ks[2]))
        out["alpha"].append(u(ks[3], (), minval=0.5, maxval=1.5))
        out["do_contrast"].append(bern(ks[4]))
        out["saturation"].append(u(ks[5], (), minval=0.5, maxval=1.5))
        out["do_saturation"].append(bern(ks[6]))
        out["hue"].append(u(ks[7], (), minval=-18.0, maxval=18.0))
        out["do_hue"].append(bern(ks[8]))
        out["perm"].append(jax.random.randint(ks[9], (), 0, 6))
        out["do_perm"].append(bern(ks[10]))
    return {k: torch.from_numpy(np.asarray(v)).to(device_aug.PARAMS[k])
            for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 5])
def test_photometric_apply_with_odtpu_draws_matches_odtpu(seed):
    B = 16
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 12, 10, 3)).astype(np.uint8)
    images[0, :3] = 128  # grey pixels: delta == 0 in the HSV round trip
    key = jax.random.PRNGKey(seed)
    params = jax_draws(key, B)
    # every branch is taken by some image and skipped by another
    for k, v in params.items():
        if v.dtype == torch.bool:
            assert v.any() and not v.all(), k
    got = device_aug.apply(_t(images).float(), params)
    want = jaug.photometric_distort_device(
        jnp.asarray(images, jnp.float32), key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)
    means = (104, 117, 123)
    got = device_aug.preprocess_train_batch(_t(images), params, means)
    want = jaug.preprocess_train_batch(jnp.asarray(images), key, means)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)
    plain = device_aug.preprocess_train_batch(_t(images), None, means,
                                              distort=False)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jaug.preprocess_train_batch(
            jnp.asarray(images), key, means, distort=False)))


def test_draw_params_are_seeded_and_in_range():
    g = torch.Generator().manual_seed(3)
    a = device_aug.draw_params(4096, g)
    b = device_aug.draw_params(4096, torch.Generator().manual_seed(3))
    for k, dtype in device_aug.PARAMS.items():
        assert a[k].dtype == dtype and a[k].shape == (4096,)
        assert torch.equal(a[k], b[k])
    for k, lo, hi in (("delta", -32, 32), ("alpha", 0.5, 1.5),
                      ("saturation", 0.5, 1.5), ("hue", -18, 18),
                      ("perm", 0, 5)):
        assert lo <= float(a[k].min()) and float(a[k].max()) <= hi, k
        assert float(a[k].float().std()) > 0.25 * (hi - lo) / 2, k
    assert set(a["perm"].tolist()) == set(range(6))
    for k in ("do_brightness", "contrast_first", "do_contrast",
              "do_saturation", "do_hue", "do_perm"):
        assert 0.45 < float(a[k].float().mean()) < 0.55, k


def test_match_batch_per_image_priors_matches_odtpu(rng, priors):
    """[B, P, 4] priors, each image's own (RefineDet's refined anchors),
    against ``odtpu``'s ``match`` vmapped over them."""
    gt, labels = _gt_batch(rng)
    B = gt.shape[0]
    per_image = priors[None] * rng.uniform(0.8, 1.2, (B,) + priors.shape)
    per_image = per_image.astype(np.float32)
    loc_t, conf_t, idx = matching.match_batch(_t(gt), _t(labels),
                                              _t(per_image), VARS, 0.5)
    jloc, jconf, jidx = jax.vmap(
        lambda g, l, p: jmatching.match(g, l, p, VARS, 0.5))(
        jnp.asarray(gt), jnp.asarray(labels, jnp.int32),
        jnp.asarray(per_image))
    assert int((conf_t > 0).sum()) > 0
    np.testing.assert_array_equal(conf_t.numpy(), np.asarray(jconf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(jloc), rtol=0,
                               atol=1e-5)
    # image 0 against the shared priors is match_batch's own answer
    shared = matching.match_batch(_t(gt[:1]), _t(labels[:1]),
                                  _t(per_image[0]), VARS, 0.5)
    assert torch.equal(shared[1][0], conf_t[0])


@pytest.mark.parametrize("n_pos", [0, 3, 20])
def test_mined_multibox_with_ignore_matches_odtpu(rng, n_pos):
    """A third of the priors ignored, positives among them: they leave
    the negative pool, and the positives still train."""
    B, P, C = 3, 50, 21
    loc = rng.randn(B, P, 4).astype(np.float32)
    loc_t = rng.randn(B, P, 4).astype(np.float32)
    conf = (rng.randn(B, P, C) * 3).astype(np.float32)
    conf_t = np.zeros((B, P), np.int64)
    for b in range(B):
        conf_t[b, rng.permutation(P)[:n_pos + b]] = rng.randint(
            1, C, n_pos + b)
    ignore = rng.rand(B, P) < 0.33
    got = losses.mined_multibox(_t(loc), _t(conf), _t(loc_t), _t(conf_t),
                                ignore=_t(ignore))
    want = jlosses.mined_multibox(jnp.asarray(loc), jnp.asarray(conf),
                                  jnp.asarray(loc_t),
                                  jnp.asarray(conf_t, jnp.int32),
                                  ignore=jnp.asarray(ignore))
    assert int(got.num_pos) == int(want.num_pos)
    np.testing.assert_allclose(float(got.loss_loc_sum),
                               float(want.loss_loc_sum), rtol=1e-5)
    np.testing.assert_allclose(float(got.loss_conf_sum),
                               float(want.loss_conf_sum), rtol=1e-5)

    logits = _t(conf)
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.clamp(_t(conf_t), min=0)[..., None])[..., 0]
    pos, neg = losses.mining_masks(ce, _t(conf_t), ignore=_t(ignore))
    grad = jax.grad(lambda c: jlosses.mined_multibox(
        jnp.asarray(loc), c, jnp.asarray(loc_t),
        jnp.asarray(conf_t, jnp.int32),
        ignore=jnp.asarray(ignore)).loss_conf_sum)(jnp.asarray(conf))
    np.testing.assert_array_equal((pos | neg).numpy(),
                                  np.abs(np.asarray(grad)).sum(-1) > 0)
    assert not (neg & _t(ignore)).any()
    # ignored positives still train: the loc sum is the one without ignore
    plain = losses.mined_multibox(_t(loc), _t(conf), _t(loc_t), _t(conf_t))
    assert bool((pos & _t(ignore)).any())
    assert torch.equal(got.loss_loc_sum, plain.loss_loc_sum)


def _refinedet_outputs(rng, P, B=2, C=21):
    """Seeded raw ARM/ODM outputs: a tenth of the ARM log-scales past the
    clamp, and a third of the anchors background to the ARM with P > 0.99
    (logits 6 apart)."""
    arm_loc = (rng.randn(B, P, 4) * 0.5).astype(np.float32)
    wild = rng.rand(B, P) < 0.1
    arm_loc[..., 2:][wild] = rng.choice([-60.0, 60.0], (wild.sum(), 2))
    arm_conf = rng.randn(B, P, 2).astype(np.float32)
    arm_conf[..., 0] += np.where(rng.rand(B, P) < 0.33, 6.0, 0.0)
    odm_loc = (rng.randn(B, P, 4) * 0.5).astype(np.float32)
    odm_conf = (rng.randn(B, P, C) * 2).astype(np.float32)
    return arm_loc, arm_conf, odm_loc, odm_conf


@pytest.mark.parametrize("use_refined", [True, False])
def test_refinedet_loss_matches_odtpu(rng, priors, use_refined):
    from odtpu_torch.ops.detect import _XFORM_CLIP

    gt, labels = _gt_batch(rng)
    B, P = gt.shape[0], priors.shape[0]
    outs = _refinedet_outputs(rng, P, B)
    assert (np.abs(outs[0][..., 2:]) > _XFORM_CLIP / VARS[1]).any()
    bg = np.exp(outs[1][..., 0]) / np.exp(outs[1]).sum(-1)
    assert 0.1 < (bg > 0.99).mean() < 0.5

    def total(r):
        return (r.arm.loss_loc_sum + r.arm.loss_conf_sum
                + r.odm.loss_loc_sum + r.odm.loss_conf_sum)

    jouts = [jnp.asarray(o) for o in outs]
    want, jgrads = jax.value_and_grad(
        lambda *o: total(jlosses.refinedet_loss(
            *o, jnp.asarray(priors), jnp.asarray(gt),
            jnp.asarray(labels, jnp.int32), VARS,
            use_refined=use_refined)), argnums=(0, 1, 2, 3))(*jouts)
    jr = jlosses.refinedet_loss(*jouts, jnp.asarray(priors), jnp.asarray(gt),
                                jnp.asarray(labels, jnp.int32), VARS,
                                use_refined=use_refined)
    touts = [_t(o).requires_grad_(True) for o in outs]
    r = losses.refinedet_loss(*touts, _t(priors), _t(gt), _t(labels), VARS,
                              use_refined=use_refined)
    total(r).backward()
    for part, jpart in ((r.arm, jr.arm), (r.odm, jr.odm)):
        assert int(part.num_pos) == int(jpart.num_pos) > 0
        for a, b in zip(part[:2], jpart[:2]):
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    for t, g in zip(touts, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())
    # the refined anchors and the filter are outside autograd: the ARM's
    # gradient is its own loss's, which is use_refined's to not change
    arm_only = [_t(o).requires_grad_(True) for o in outs[:2]]
    losses.multibox_loss(*arm_only, _t(priors), _t(gt),
                         _t(np.where(labels >= 0, 0, -1)), VARS) \
        .loss_loc_sum.backward()
    assert torch.equal(arm_only[0].grad, touts[0].grad)
