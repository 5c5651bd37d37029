"""The port's train path against the JAX package on the CPU: the LR
schedule, the optimizer update, one full SSD300 train step, and the
train loop's checkpoints and resume.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances, and why:
- the schedule: equal (both compute in float32, in the same order);
- two optimizer steps against optax: rtol 1e-6 (the same float32
  arithmetic; an FMA or a reduction order can move the last ulp);
- one full train step (f32, B=2, the flagship weights): the loss within
  rtol 1e-4 and each parameter's update within a relative L2 error of
  1e-3. Each conv sums ~10^4 products in another order in the two
  frameworks, through 23 layers forward and back;
- the resumed run against the unbroken one: bit-equal (the same
  program on the same CPU).
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from odtpu.models import model_factory as jmodel_factory
from odtpu.parallel import train as jtrain
from odtpu.utils.checkpoint import load_model_npz as jload_model_npz
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch import train_step
from odtpu_torch.utils.checkpoint import load_odtpu_npz
from odtpu_torch.utils.config import default_cfg

from test_torch_loss import jax_draws
from test_torch_model import FLAGSHIP

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)


def _both_cfgs(**train):
    cfgs = jdefault_cfg(), default_cfg()
    for c in cfgs:
        for k, v in train.items():
            node = c.TRAIN
            *path, leaf = k.split(".")
            for p in path:
                node = node[p]
            node[leaf] = v
    return cfgs


@pytest.mark.parametrize("warm,max_iter", [(0, 12), (3, 12), (3, 13),
                                           (4, 100)])
def test_lr_schedule_matches_odtpu(warm, max_iter):
    steps = (5, 8, 12)
    jcfg, cfg = _both_cfgs(**{"MAX_ITER": max_iter,
                              "LR_SCHEDULER.STEPS": steps,
                              "LR_SCHEDULER.WARMUP_ITERS": warm,
                              "LR_SCHEDULER.GAMMA": 0.1,
                              "OPTIMIZER.LR": 1e-3})
    want = jtrain.lr_schedule(jcfg)
    got = train_step.lr_schedule(cfg)
    at = {0, 1, warm - 1, warm, max_iter, max_iter + 1}
    at |= {s - 1 for s in steps} | set(steps)
    for s in sorted(x for x in at if x >= 0):
        assert got(s) == float(np.float32(want(jnp.int32(s)))), s
    # the boundary at MAX_ITER is dropped
    assert got(12) == got(11) if max_iter == 12 else got(12) < got(11)


def _random_tree(rng):
    return {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": rng.randn(2, 3, 5).astype(np.float32)}


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_two_optimizer_steps_match_optax(rng, name):
    """The second step's gradients are scaled up so the clip triggers."""
    jcfg, cfg = _both_cfgs(**{"OPTIMIZER.OPTIMIZER": name,
                              "OPTIMIZER.CLIP_GRAD_NORM": 10.0,
                              "OPTIMIZER.LR": 1e-2,
                              "LR_SCHEDULER.WARMUP_ITERS": 1})
    params = _random_tree(rng)
    grads = [_random_tree(rng), {k: 10 * v for k, v in
                                 _random_tree(rng).items()}]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gr.values()))
             for gr in grads]
    assert norms[0] < 10.0 < norms[1]

    tx, _ = jtrain.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    module = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                               for k, v in params.items()})
    state = train_step.TrainState(module, train_step.make_optimizer(
        module.parameters(), cfg))
    step = train_step.make_train_step(torch.zeros(1, 4), cfg)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        step.update(state)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7)
    assert state.step == 2


def test_train_step_refuses_unported_parts():
    # the repulsion loss and remat are ported: a narrow 64x64 SSD takes
    # one CPU step with both on and reports a finite loss_repul
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.LOSS.REPULSION_WEIGHT, cfg.TPU.REMAT = 0.1, True
    cfg.DATASET.IMAGE_SIZE = cfg.MODEL.IMAGE_SIZE = (64, 64)
    cfg.MODEL.STEPS = [8, 16, 32, 64]
    cfg.MODEL.MIN_SIZES = [8, 16, 32, 48]
    cfg.MODEL.MAX_SIZES = [16, 32, 48, 64]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2], [2], [2]]
    cfg.MODEL.EXTRAS = [64, "S", 128, 64, "S", 128]
    state, priors = train_step.create_train_state(cfg, "cpu")
    step = train_step.make_train_step(priors, cfg)
    assert step.remat and step.rep_w == 0.1
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        -100, 100, (2, 64, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.6], [0.3, 0.3, 0.9, 0.8]]] * 2)
    labels = torch.tensor([[3, 7], [3, -1]])
    metrics = step(state, images, boxes, labels)
    assert state.step == 1 and torch.isfinite(metrics["loss_repul"])
    assert torch.isfinite(metrics["loss"])
    # RefineDet trains: its step takes the two-step loss
    cfg = default_cfg()
    cfg.MODEL.SSD_TYPE = "RefineDet"
    assert train_step.make_train_step(torch.zeros(1, 4), cfg).refinedet
    step = train_step.make_train_step(torch.zeros(1, 4), default_cfg())
    with pytest.raises(TypeError, match="DEVICE_PHOTOMETRIC"):
        step.augment(torch.zeros(1, 4, 4, 3, dtype=torch.uint8), 0)


# SSD300's prior scales (MIN_SIZES / 300) and the side of each scale's map
_SCALES = ((0.1, 38), (0.2, 19), (0.37, 10), (0.54, 5), (0.71, 3),
           (0.88, 1))


def _gt(rng, B, G=60):
    """3 + b random boxes per image, then one box for each prior scale on
    a random cell of that scale's map, so that every head and every extra
    layer gets a gradient."""
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -1, np.int32)
    for b in range(B):
        n = 3 + b
        xy = rng.uniform(0.05, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.35, (n, 2))
        boxes[b, :n] = np.concatenate([xy, xy + wh], 1)
        for i, (side, cells) in enumerate(_SCALES):
            c = (rng.randint(cells, size=2) + 0.5) / cells
            half = side * rng.uniform(0.85, 1.15, 2) / 2
            boxes[b, n + i] = np.clip(np.concatenate([c - half, c + half]),
                                      0.0, 1.0)
        labels[b, :n + len(_SCALES)] = rng.randint(0, 20, n + len(_SCALES))
    return boxes, labels


def _flat_odtpu(params):
    import flax
    return {"/".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(params).items()}


def test_one_ssd300_train_step_matches_odtpu(rng):
    if not osp.isfile(FLAGSHIP):
        pytest.skip("the flagship checkpoint is not in this checkout")
    B = 2
    images = rng.randint(0, 256, (B, 300, 300, 3)).astype(np.uint8)
    boxes, labels = _gt(rng, B)

    jcfg, cfg = jdefault_cfg(), default_cfg()
    for c in (jcfg, cfg):
        c.TPU.COMPUTE_DTYPE = "float32"
        c.DATASET.DEVICE_PHOTOMETRIC = True
    jmodel, jpriors, _ = jmodel_factory("train", jcfg)
    jstate, tx = jtrain.create_train_state(jmodel, jcfg)
    params, loaded, _ = jload_model_npz(jax.device_get(jstate.params),
                                        FLAGSHIP)
    assert len(loaded) == 71
    jstate = jstate.replace(params=params)
    jstep = jtrain.make_train_step(jmodel, jpriors, jcfg, tx, donate=False)
    jnew, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(boxes),
                           jnp.asarray(labels))

    state, priors = train_step.create_train_state(cfg, "cpu")
    state.model.load_state_dict(load_odtpu_npz(FLAGSHIP, state.model))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = train_step.make_train_step(priors, cfg)
    draws = jax_draws(jax.random.fold_in(jax.random.PRNGKey(17), 0), B)
    metrics = step(state, torch.from_numpy(images), torch.from_numpy(boxes),
                   torch.from_numpy(labels), aug_params=draws)

    assert int(metrics["num_pos"]) == int(jmetrics["num_pos"]) > 0
    for k in ("loss", "loss_loc", "loss_conf"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4)
    old, new = _flat_odtpu(jstate.params), _flat_odtpu(jnew.params)
    after = state.model.state_dict()
    errs = {}
    for key in old:
        want = new[key] - old[key]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        name = key.replace("/", ".").replace("kernel", "weight")
        got = (after[name] - before[name]).numpy()
        errs[key] = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert len(errs) == 71
    # every update holds a gradient, not weight decay alone
    assert all(bool(p.grad.any()) for p in state.model.parameters())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
