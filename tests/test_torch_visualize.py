"""The port's TensorBoard images and the eval-mode norm's backward against
``odtpu`` on the CPU, on numpy-seeded inputs.

- ``ops.cuda.batch_norm``'s backward (``BnEvalFn`` on the CPU, its plain
  version ``bn_eval_backward_plain``) against ``jax.grad`` through
  ``odtpu``'s batch-normed ``Conv`` in eval mode (a 1x1 identity conv,
  exact, then flax's norm in float32 and the casts): ``dx`` bit-equal in
  float32 and float64 and within one bf16 ulp in bfloat16; the CPU
  norm's own ``dscale`` and ``dbias`` (``bn_eval_plain`` under autograd)
  within 1e-6 relative (1e-12 in float64: ``odtpu`` with its float32
  casts widened); ``gradcheck`` of the Function's CPU path, and its
  refusal of a parameter gradient.
- ``utils.visualize``'s numpy drawing against ``odtpu``'s OpenCV calls:
  ``draw_boxes`` bit-equal without text on 50 boxes (off the edges,
  reversed, points) and equal outside the label bands with text (the
  port's 3x5 font is not cv2's Hershey font); ``vis_img_box``,
  ``viz_feature_maps``, ``viz_anchor_strategy``, ``anchor_match_stats``
  and ``viz_prior_anchors`` (bit-equal on the blank background, within
  one level on an image, which the host resize scales) through
  recording writers; the augmentation dumps' tags, steps and outputs,
  and the PR curves' arrays.
"""

import contextlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from odtpu.data.augment import SSDAugmentation as JSSDAugmentation
from odtpu.models.common import Conv as JConv
from odtpu.ops.priors import PriorBoxSSD as JPriorBoxSSD
from odtpu.utils import visualize as jvis
from odtpu.utils.config import load_cfg as jload_cfg
from odtpu.utils.logging import TBWriter as JTBWriter

from odtpu_torch.data.augment import SSDAugmentation
from odtpu_torch.data.voc import VOC_CLASSES
from odtpu_torch.models import probe_layer_dims
from odtpu_torch.ops.cuda import batch_norm as bn_ops
from odtpu_torch.ops.priors import PriorBoxSSD
from odtpu_torch.utils import visualize as vis
from odtpu_torch.utils.config import load_cfg
from odtpu_torch.utils.logging import TBWriter

import torch_family_parity as fp

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_bn_eval_backward_matches_jax_grad(dtype):
    rng = np.random.RandomState(3)
    n, h, w, c = 2, 5, 6, 8
    x = (rng.randn(n, h, w, c) * 3).astype(np.float32)
    dy = rng.randn(n, h, w, c).astype(np.float32)
    scale, var = (rng.uniform(0.5, 1.5, c).astype(np.float32)
                  for _ in range(2))
    bias, mean = (rng.uniform(-0.5, 0.5, c).astype(np.float32)
                  for _ in range(2))
    wide = np.float64 if dtype == "float64" else np.float32
    with fp.odtpu_float64() if dtype == "float64" \
            else contextlib.nullcontext():
        jdt = jnp.dtype(dtype)
        conv = JConv(features=c, kernel=1, relu=False, batch_norm=True,
                     dtype=jdt)
        params = {"conv": {"kernel": jnp.eye(c, dtype=wide)[None, None]},
                  "bn": {"scale": jnp.asarray(scale, wide),
                         "bias": jnp.asarray(bias, wide)}}
        stats = {"bn": {"mean": jnp.asarray(mean, wide),
                        "var": jnp.asarray(var, wide)}}
        jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)

        def f(xx, p):
            return conv.apply({"params": p, "batch_stats": stats}, xx,
                              train=False)

        out, vjp = jax.vjp(f, jx, params)
        assert out.dtype == jdt
        jdx, jparams = vjp(jdy)
        jdx = np.asarray(jdx.astype(wide))
        jdscale = np.asarray(jparams["bn"]["scale"])
        jdbias = np.asarray(jparams["bn"]["bias"])
        # flax's mul = rsqrt(var + eps) * scale takes XLA's rsqrt, which
        # can round otherwise than torch's: the port's norm is handed the
        # same rsqrt, so that the backward's own rounding is what differs
        rsqrt = np.array(jax.lax.rsqrt(stats["bn"]["var"] + 1e-5))

    tdt = getattr(torch, dtype)
    weight, bias_t = (torch.from_numpy(v.astype(wide)).requires_grad_()
                      for v in (scale, bias))
    mean_w = torch.from_numpy(mean.astype(wide))
    mul = torch.from_numpy(rsqrt) * weight
    # NHWC values in an NCHW tensor: channels-last strides, as served
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    dyt = torch.from_numpy(dy).to(tdt).permute(0, 3, 1, 2)
    y = bn_ops.BnEvalFn.apply(xt, mean_w, mul.detach(), bias_t.detach())
    dx, = torch.autograd.grad(y, xt, dyt)
    assert torch.equal(bn_ops.bn_eval_backward_plain(dyt, mul.detach()), dx)
    # the CPU norm's parameter gradients: bn_eval_plain under autograd
    y = bn_ops.bn_eval_plain(xt, mean_w, mul, bias_t)
    plain_dx, dweight, dbias = torch.autograd.grad(y, (xt, weight, bias_t),
                                                   dyt)
    assert torch.equal(plain_dx, dx)
    got = dx.to(torch.float64).permute(0, 2, 3, 1).numpy()
    if dtype == "bfloat16":
        bits = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                .view(torch.int16).to(torch.int32) for a in (got, jdx)]
        assert int((bits[0] - bits[1]).abs().max()) <= 1
    else:
        np.testing.assert_array_equal(got, jdx)
    tol = 1e-12 if dtype == "float64" else 1e-6
    assert _rel(dweight.numpy(), jdscale) <= tol
    assert _rel(dbias.numpy(), jdbias) <= tol


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
def test_bn_eval_fn_gradcheck(layout):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 4, 5, generator=g, dtype=torch.float64)
    x = x.contiguous(memory_format=layout).requires_grad_()
    params = [torch.randn(3, generator=g, dtype=torch.float64)
              for _ in range(3)]
    assert torch.autograd.gradcheck(bn_ops.BnEvalFn.apply, (x, *params))
    for i in range(3):
        wanting = [p.clone().requires_grad_(j == i)
                   for j, p in enumerate(params)]
        with pytest.raises(RuntimeError, match="no gradient of mean"):
            bn_ops.BnEvalFn.apply(x, *wanting)


def _boxes(seed, h, w, n=50):
    """Seeded pixel boxes: off every edge, reversed, and points."""
    rng = np.random.RandomState(seed)
    b = rng.uniform(-0.3, 1.3, (n, 4)) * np.array([w, h, w, h])
    b[::7, 2:] = b[::7, :2]
    b[3::11, 2] = b[3::11, 0] - 5
    return b.astype(np.float32)


def _text_band(shape, boxes, texts):
    """Where either package may draw a label: cv2's text box at draw_boxes'
    anchor, widened to the port's text, and a pixel more each way."""
    h, w = shape[:2]
    band = np.zeros((h, w), bool)
    for b, text in zip(boxes, texts):
        x = int(np.clip(b[0], 0, w - 1))
        y = max(int(np.clip(b[1], 0, h - 1)) - 3, 10)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                         0.45, 1)
        tw = max(tw, vis.GLYPH_ADVANCE * len(text))
        band[max(y - th - 2, 0):y + base + 3, max(x - 2, 0):x + tw + 3] = True
    return band


@pytest.mark.parametrize("text", [False, True], ids=["boxes", "labels"])
def test_draw_boxes_equals_odtpu(text):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    boxes = _boxes(6, 120, 160)
    if not text:
        np.testing.assert_array_equal(
            vis.draw_boxes(img, boxes, color=(0, 0, 255)),
            jvis.draw_boxes(img, boxes, color=(0, 0, 255)))
        return
    labels = rng.randint(0, 20, len(boxes))
    scores = rng.uniform(0, 1, len(boxes))
    names = list(VOC_CLASSES)
    got = vis.draw_boxes(img, boxes, labels, scores, class_names=names)
    want = jvis.draw_boxes(img, boxes, labels, scores, class_names=names)
    texts = ["{} {:.2f}".format(names[li], s) for li, s in zip(labels, scores)]
    band = _text_band(img.shape, boxes, texts)
    assert band.mean() < 0.9
    np.testing.assert_array_equal(got[~band], want[~band])
    assert not np.array_equal(got[band], img[band])  # the labels are there


def test_vis_img_box_feature_maps_and_histograms_equal_odtpu():
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (90, 110, 3)).astype(np.uint8)
    gt = np.concatenate([_boxes(8, 90, 110, 6),
                         rng.randint(1, 21, (6, 1))], 1).astype(np.float32)
    pred = np.concatenate([rng.uniform(0, 1, (5, 1)), _boxes(9, 90, 110, 5),
                           rng.randint(1, 21, (5, 1))], 1).astype(np.float32)
    sources = [rng.randn(1, s, s, 4).astype(np.float32) for s in (9, 5, 1)]
    stats = {"gt_w": rng.uniform(0, 1, 7), "anchor_w": np.zeros(0),
             "matched_per_gt": rng.randint(0, 9, 7)}
    tb = chip_smoke.recording_writer()
    jtb = chip_smoke.recording_writer(JTBWriter)
    vis.vis_img_box(img, {"gt": gt, "pred": pred}, tb, tag="t", step=3)
    jvis.vis_img_box(img, {"gt": gt, "pred": pred}, jtb, tag="t", step=3)
    vis.viz_feature_maps([torch.from_numpy(s).permute(0, 3, 1, 2)
                          for s in sources], tb)
    jvis.viz_feature_maps(sources, jtb)
    vis.viz_anchor_strategy(stats, tb, step=2)
    jvis.viz_anchor_strategy(stats, jtb, step=2)
    got, want = tb.writer.images, jtb.writer.images
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    assert [t for t, _, _ in got] == ["t"] + ["features/source_{}".format(i)
                                              for i in range(3)]
    # the boxes' labels: outside their bands (RGB in TB)
    texts = [str(int(r[4])) for r in gt] + ["{} {:.2f}".format(
        int(r[5]), r[0]) for r in pred]
    band = _text_band(img.shape, np.concatenate([gt[:, :4], pred[:, 1:5]]),
                      texts)
    np.testing.assert_array_equal(got[0][1][~band], want[0][1][~band])
    for (_, a, _), (_, b, _) in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert [(t, s) for t, _, s in tb.writer.histograms] == [
        ("anchors/gt_w", 2), ("anchors/matched_per_gt", 2)]
    for (_, a, _), (_, b, _) in zip(tb.writer.histograms,
                                    jtb.writer.histograms):
        np.testing.assert_array_equal(a, b)
    vis.viz_anchor_strategy(stats, TBWriter(""))  # no writer: nothing


def test_anchor_match_stats_equal_odtpu():
    cfg = load_cfg("ssd_vgg16_voc")
    priors = PriorBoxSSD(cfg)(probe_layer_dims(cfg))
    rng = np.random.RandomState(10)
    gt_boxes, gt_labels = [], []
    for b in range(2):
        xy = rng.uniform(0, 0.6, (5, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (5, 2))], 1)
        labels = rng.randint(0, 20, 5)
        labels[3 + b % 2:] = -1  # padding
        gt_boxes.append(boxes.astype(np.float32))
        gt_labels.append(labels)
    gt_boxes.append(gt_boxes[0])
    gt_labels.append(np.full(5, -1))  # an image with no ground truth
    got = vis.anchor_match_stats(priors, gt_boxes, gt_labels)
    want = jvis.anchor_match_stats(priors, gt_boxes, gt_labels)
    assert got.keys() == want.keys()
    assert len(got["matched_per_gt"]) == 7 and got["anchor_w"].size > 7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        if k != "best_iou_per_gt":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("background", ["blank", "image"])
def test_viz_prior_anchors_equal_odtpu(background):
    cfg = load_cfg("ssd_vgg16_voc")
    dims = probe_layer_dims(cfg)
    image = None
    if background == "image":
        image = np.random.RandomState(11).randint(
            0, 256, (375, 500, 3)).astype(np.uint8)
    tb = chip_smoke.recording_writer()
    jtb = chip_smoke.recording_writer(JTBWriter)
    vis.viz_prior_anchors(PriorBoxSSD(cfg), dims, tb, image=image)
    jvis.viz_prior_anchors(JPriorBoxSSD(jload_cfg()), dims, jtb, image=image)
    got, want = tb.writer.images, jtb.writer.images
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    assert len(got) == sum(PriorBoxSSD(cfg).num_priors) == 30
    for (tag, a, _), (_, b, _) in zip(got, want):
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= (0 if image is None else 1), tag


@pytest.mark.parametrize("device_photometric", [True, False],
                         ids=["uint8", "float"])
def test_augmentation_dumps_equal_odtpu(device_photometric):
    """The dumps of the first 3 of 5 items: the same tags and steps,
    images of the same shapes, and the dumped items' outputs equal
    (bit for bit on the uint8 path; the float path's cv2 colour and
    resize arithmetic within 1e-3 a level, as tests/test_torch_data.py
    holds it)."""
    rng = np.random.RandomState(12)
    kw = dict(size=(96, 96), device_photometric=device_photometric)
    aug, jaug = SSDAugmentation(**kw), JSSDAugmentation(**kw)
    tb = chip_smoke.recording_writer()
    jtb = chip_smoke.recording_writer(JTBWriter)
    aug.attach_writer(tb, max_dumps=3)
    jaug.attach_writer(jtb, max_dumps=3)
    for i in range(5):
        img = rng.randint(0, 256, (70 + 9 * i, 90, 3)).astype(np.uint8)
        xy = rng.uniform(0.05, 0.5, (2, 2))
        boxes = np.concatenate([xy, xy + 0.3], 1).astype(np.float32)
        labels = np.array([3, 7])
        got = aug(img, boxes, labels, np.random.default_rng(i))
        want = jaug(img, boxes, labels, np.random.default_rng(i))
        tol = 0 if device_photometric else 1e-3 * 255
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])
    stages = ["0_input", "2_expand", "3_crop", "4_mirror", "5_resize"]
    if not device_photometric:
        stages.insert(1, "1_photometric")
    want_tags = [("augmentation/" + s, i) for i in range(3) for s in stages]
    got, want = tb.writer.images, jtb.writer.images
    assert [(t, s) for t, _, s in got] == want_tags
    assert [(t, s) for t, _, s in want] == want_tags
    assert [a.shape for _, a, _ in got] == [b.shape for _, b, _ in want]


def test_pr_curves_equal_odtpu():
    rng = np.random.RandomState(13)
    res = [("cls{}".format(i), 0.5, np.sort(rng.uniform(0, 1, n))[::-1],
            np.sort(rng.uniform(0, 1, n))) for i, n in enumerate((4, 0, 9))]
    res.append(("none", 0.0, 0.0, 0.0))  # a class with no detections
    tb = chip_smoke.recording_writer()
    jtb = chip_smoke.recording_writer(JTBWriter)
    tb.add_pr_curves(res, step=5)
    jtb.add_pr_curves(res, step=5)
    got, want = tb.writer.curves, jtb.writer.curves
    assert [t for t, _ in got] == [t for t, _ in want] == ["pr/cls0",
                                                           "pr/cls2"]
    for (_, a), (_, b) in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
