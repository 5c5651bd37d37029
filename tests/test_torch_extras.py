"""The training extras of the port against ``odtpu`` on the CPU: ``iog``,
``match_second_best``, the repulsion loss and the focal loss, a train
step with ``LOSS.REPULSION_WEIGHT`` and one with ``TPU.REMAT``.

Inputs are made with numpy from a seed: several GT boxes an image, some
padded rows, and an image with a single GT, where no prior may have a
second GT. Tolerances, and why:
- ``iog``, the second-best GT, the repulsion and focal losses: the value
  within 1e-6 (relative for the sums), the gradient within 1e-5 of its
  largest entry: the same float32 operations, summed in another order;
- the narrow 64x64 SSD step with ``REPULSION_WEIGHT = 0.5`` against
  ``odtpu``'s ``make_train_step``: tests/test_torch_train_families.py's
  limits (losses rtol 1e-4, ``loss_repul`` too, updates 1e-2, running
  statistics 1e-5); the narrow FPN-BN step under ``TPU.REMAT`` on both
  sides in float64, as tests/test_torch_train_narrow64.py holds its
  steps (updates 1e-3, running statistics 1e-5);
- the FPN-BN step with remat against the same step without it, from the
  same state: updates and running statistics within 1e-6 (relative L2),
  the running statistics having moved once.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odtpu.models
from odtpu.layers import losses as jlosses
from odtpu.ops import boxes as jboxes
from odtpu.ops import matching as jmatching

from odtpu_torch.layers import losses
from odtpu_torch.ops import boxes, matching
from odtpu_torch.ops.priors import prior_factory
from odtpu_torch.train_step import make_train_step
from odtpu_torch.utils.config import default_cfg

import chip_smoke
import test_torch_train_families as ttf

torch.set_num_threads(2)

VARIANCES = (0.1, 0.2)


@pytest.fixture
def odtpu_init_jitted():
    """``odtpu``'s ``init_model`` under one ``jax.jit``: the same seeded
    draw, which both packages' steps then start from, compiled once
    instead of op by op (~22 s eagerly for the narrow FPN-BN)."""
    def init(model, cfg, rng=None, batch_size=1):
        h, w = cfg.MODEL.IMAGE_SIZE
        dummy = jnp.zeros((batch_size, h, w, 3), jnp.float32)
        return jax.jit(lambda r: model.init(r, dummy, train=False))(
            jax.random.PRNGKey(0) if rng is None else rng)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(odtpu.models, "init_model", init)
        yield


def _priors():
    cfg = ttf.tiny_cfg(default_cfg(), "SSD")
    return torch.from_numpy(
        prior_factory(cfg)([(8, 8), (4, 4), (2, 2), (1, 1)]))


def _scene(seed=0, B=3, G=6):
    """Padded GT [B, G, 4] / [B, G] with 2..G boxes an image that
    overlap each other, image 0 with a single GT; loc [B, P, 4] that
    decodes near the priors."""
    rng = np.random.RandomState(seed)
    P = _priors().shape[0]
    gt = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -1, np.int32)
    for b in range(B):
        n = 1 if b == 0 else min(G, 2 + 2 * b)
        xy = rng.uniform(0.05, 0.55, (n, 2))
        wh = rng.uniform(0.15, 0.45, (n, 2))
        gt[b, :n] = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
        labels[b, :n] = rng.randint(0, 20, n)
    loc = rng.normal(0, 0.5, (B, P, 4)).astype(np.float32)
    return loc, gt, labels


def _close_grad(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def test_iog_matches_odtpu():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 0.6, (2, 50, 2))
    a = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (2, 50, 2))], -1)
    xy = rng.uniform(0, 0.6, (2, 50, 2))
    b = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (2, 50, 2))], -1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    w = rng.uniform(size=(2, 50)).astype(np.float32)
    want = jboxes.iog(jnp.asarray(a), jnp.asarray(b))
    tb = torch.from_numpy(b).requires_grad_()
    got = boxes.iog(torch.from_numpy(a), tb)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert (np.asarray(want) > 0).sum() > 10
    (got * torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda bb: jnp.sum(
        jboxes.iog(jnp.asarray(a), bb) * w))(jnp.asarray(b))
    _close_grad(tb.grad.numpy(), jgrad)


def test_match_second_best_matches_odtpu():
    loc, gt, labels = _scene()
    priors = _priors()
    _, _, best = matching.match_batch(torch.from_numpy(gt),
                                      torch.from_numpy(labels), priors,
                                      VARIANCES, 0.5)
    second, has = matching.match_second_best(
        torch.from_numpy(loc), torch.from_numpy(gt),
        torch.from_numpy(labels), priors, VARIANCES, best)
    jpriors = jnp.asarray(priors.numpy())
    for b in range(gt.shape[0]):
        _, _, jbest = jmatching.match(jnp.asarray(gt[b]),
                                      jnp.asarray(labels[b]), jpriors,
                                      VARIANCES, 0.5)
        np.testing.assert_array_equal(best[b].numpy(), jbest)
        jsecond, jhas = jmatching.match_second_best(
            jnp.asarray(loc[b]), jnp.asarray(gt[b]), jnp.asarray(labels[b]),
            jpriors, VARIANCES, jbest)
        np.testing.assert_array_equal(has[b].numpy(), jhas)
        np.testing.assert_array_equal(second[b].numpy(), jsecond)
    assert not has[0].any()  # one GT: nothing to repel from
    assert has[1:].any()
    # one image at a time gives the batch's rows
    s1, h1 = matching.match_second_best(
        torch.from_numpy(loc[2]), torch.from_numpy(gt[2]),
        torch.from_numpy(labels[2]), priors, VARIANCES, best[2])
    assert torch.equal(s1, second[2]) and torch.equal(h1, has[2])


def test_repulsion_loss_matches_odtpu():
    loc, gt, labels = _scene(seed=2)
    priors = _priors()
    tloc = torch.from_numpy(loc).requires_grad_()
    total, count = losses.repulsion_loss(tloc, priors, torch.from_numpy(gt),
                                         torch.from_numpy(labels), VARIANCES)

    def jloss(l):
        return jlosses.repulsion_loss(l, jnp.asarray(priors.numpy()),
                                      jnp.asarray(gt), jnp.asarray(labels),
                                      VARIANCES)

    jtotal, jcount = jax.jit(jloss)(jnp.asarray(loc))
    assert int(count) == int(jcount) > 0
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
    total.backward()
    jgrad = jax.jit(jax.grad(lambda l: jloss(l)[0]))(jnp.asarray(loc))
    _close_grad(tloc.grad.numpy(), jgrad)
    # the single-GT image repels nothing: its loc gets no gradient
    assert not tloc.grad[0].any()
    x = torch.linspace(0, 1, 101)
    np.testing.assert_allclose(losses._smooth_ln(x).numpy(),
                               jlosses._smooth_ln(jnp.asarray(x.numpy())),
                               rtol=1e-6, atol=1e-6)


def test_focal_loss_matches_odtpu():
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 2, (2, 40, 21)).astype(np.float32)
    conf_t = rng.randint(0, 21, (2, 40)) * (rng.uniform(size=(2, 40)) < 0.3)
    t = torch.from_numpy(logits).requires_grad_()
    got = losses.focal_loss(t, torch.from_numpy(conf_t))
    want = jlosses.focal_loss(jnp.asarray(logits), jnp.asarray(conf_t))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    jgrad = jax.grad(lambda x: jlosses.focal_loss(x, jnp.asarray(conf_t)))(
        jnp.asarray(logits))
    _close_grad(t.grad.numpy(), jgrad)


def _with(monkeypatch, **keys):
    """Make ``ttf.tiny_cfg`` set ``keys`` ("LOSS.REPULSION_WEIGHT": 0.5)
    on both packages' configs."""
    tiny = ttf.tiny_cfg

    def patched(cfg, *case):
        cfg = tiny(cfg, *case)
        for key, value in keys.items():
            node, leaf = key.split(".")
            cfg[node][leaf] = value
        return cfg

    monkeypatch.setattr(ttf, "tiny_cfg", patched)


def test_narrow_step_with_repulsion_matches_odtpu(monkeypatch,
                                                  odtpu_init_jitted):
    _with(monkeypatch, **{"LOSS.REPULSION_WEIGHT": 0.5})
    jstate, jstep, state, step, cfg, dims = ttf._pair_states(
        ("SSD", "vgg16", False), monkeypatch)
    images, gt, labels = ttf.narrow_batch(cfg, dims)
    _, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(gt),
                  jnp.asarray(labels))
    m, _, _, _ = ttf.fp.check_train_step(jstate, jstep, state, step, images,
                                         gt, labels, update_tol=1e-2)
    assert float(m["loss_repul"]) > 0
    np.testing.assert_allclose(float(m["loss_repul"]),
                               float(jm["loss_repul"]), rtol=1e-4)


def test_narrow_remat_step_equals_plain_and_odtpu(monkeypatch,
                                                  odtpu_init_jitted):
    """FPN over VGG16-BN, its norms drawn at random, in float64 on both
    sides (tests/test_torch_train_narrow64.py's step): float32 steps of
    this net lie 1.3e-2 apart with remat and without it alike, ReLU signs
    flipping under rounding."""
    _with(monkeypatch, **{"TPU.REMAT": True})
    with ttf.fp.odtpu_float64():
        jstate, jstep, state, step, cfg, dims = ttf._pair_states(
            ("FPN", "vgg16", True), monkeypatch, "float64")
        assert step.remat
        images, gt, labels = ttf.narrow_batch(cfg, dims)
        images = images.astype(np.float64)
        plain_state = copy.deepcopy(state)
        before = chip_smoke.running_stats(state.model)
        plain_cfg = copy.deepcopy(cfg)
        plain_cfg.TPU.REMAT = False
        plain_step = make_train_step(step.priors, plain_cfg)
        plain_step(plain_state, torch.from_numpy(images),
                   torch.from_numpy(gt), torch.from_numpy(labels))
        _, _, stats, _ = ttf.fp.check_train_step(
            jstate, jstep, state, step, images, gt, labels)
    assert stats
    # against the same step without remat: the updates, and the running
    # statistics, moved once
    opt, plain_opt = state.optimizer.state, plain_state.optimizer.state
    plain_params = dict(plain_state.model.named_parameters())
    for name, p in state.model.named_parameters():
        assert chip_smoke.rel_l2(
            opt[p]["momentum_buffer"],
            plain_opt[plain_params[name]]["momentum_buffer"]) <= 1e-6, name
    after = chip_smoke.running_stats(state.model)
    plain_after = chip_smoke.running_stats(plain_state.model)
    for name, value in after.items():
        assert chip_smoke.rel_l2(value, plain_after[name]) <= 1e-6, name
        assert not torch.equal(value, before[name]), name
