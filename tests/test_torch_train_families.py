"""Training the detector families in the port against ``odtpu`` on the
CPU, at small size, and the train loop's batch-norm contract.

- One float32 step of FPN, FSSD (the 4-map pyramid of
  tests/test_family_train.py), SSD over DRN-D-22, DRN_SSD and SSD over
  VGG16-BN at 64x64, batch 2, from ``odtpu``'s init with every batch
  norm's scale, bias and statistics drawn at random, against
  ``odtpu``'s ``make_train_step`` (tests/torch_family_parity.py
  ``check_train_step``): num_pos equal, the losses within rtol 1e-4,
  the running statistics after the step within 1e-5 (relative L2: 0.9
  of the old value plus 0.1 of a batch statistic that the two frameworks
  sum in another order), a gradient on every parameter that feeds the
  loss, every update within a relative L2 error of 1e-2. The same step
  taken in float64 on both sides (tests/test_torch_train_narrow64.py)
  holds every update within 1e-3. The float32 steps are held to 1e-2,
  not 1e-3: a ReLU sign flipped by rounding sends the whole gradient at
  that position the other way, so two float32 steps of these
  batch-normed nets can lie farther apart than either lies from the
  float64 step (chip_smoke.py's family_train_parity counts such flips
  at full width).
- ``fit``'s validation runs a batch-normed model in eval mode: its
  running statistics come out bit-equal and its rows equal those of the
  same model put in ``eval()`` by hand; it goes back to train mode.
- After a train step the checkpointer round-trips the running statistics
  bit-equal, ``to_odtpu_params`` writes them under ``__batch_stats__/``,
  and ``--basenet`` moves the flagship's 15 VGG convs (30 arrays) into
  RFBNet300 and RefineDet320, as cfgs/tests/{rfbnet,refinedet}_ft.yml
  train them, and whatever else ``odtpu`` moves.
- Every configuration builds a train state and a step.
"""

import copy
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.models import init_model, model_factory as jmodel_factory
from odtpu.models import probe_layer_dims as jprobe_layer_dims
from odtpu.models.fssd import FSSD as JFSSD
from odtpu.models.vgg import VGG16 as JVGG16
from odtpu.ops.priors import prior_factory as jprior_factory
from odtpu.parallel import train as jtrain
from odtpu.utils.checkpoint import load_model_npz as jload_model_npz
from odtpu.utils.config import default_cfg as jdefault_cfg
from odtpu.utils.config import load_cfg as jload_cfg

from odtpu_torch.data.loader import DetLoader, NetworkInput
from odtpu_torch.data.voc import VOCDetection
from odtpu_torch.eval.evaluator import EvalVOC
from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.models import fssd, probe_layer_dims
from odtpu_torch.train import fit
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils.checkpoint import (BATCH_STATS_PREFIX, Checkpointer,
                                          from_odtpu_params, load_basenet,
                                          load_strict, to_odtpu_params)
from odtpu_torch.utils.config import CFGS, default_cfg, load_cfg

import torch_family_parity as fp
from synth import make_voc
from test_torch_model import FLAGSHIP
from torch_tmp import drop_module_tmp  # noqa: F401

# tests/test_family_train.py's tiny FSSD pyramid: 8/4/2/1 from 64x64
TINY_PYRAMID = ((128, 1, 1), (128, 2, 1), (128, 2, 1), (128, 2, 1))


def tiny_cfg(cfg, ssd_type, base="vgg16", batch_norm=False):
    """tests/test_family_train.py's 64x64 settings, on either package's
    config tree."""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.SSD_TYPE, cfg.MODEL.BASE = ssd_type, base
    cfg.MODEL.BATCH_NORM = batch_norm
    cfg.DATASET.IMAGE_SIZE = (64, 64)
    cfg.MODEL.IMAGE_SIZE = (64, 64)
    cfg.MODEL.STEPS = [8, 16, 32, 64]
    cfg.MODEL.MIN_SIZES = [8, 16, 32, 48]
    cfg.MODEL.MAX_SIZES = [16, 32, 48, 64]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2], [2], [2]]
    cfg.MODEL.EXTRAS = [64, "S", 128, 64, "S", 128]
    cfg.TRAIN.OPTIMIZER.LR = 1e-3
    cfg.TRAIN.OPTIMIZER.CLIP_GRAD_NORM = 5.0
    return cfg


def _jax_model(jcfg):
    """``odtpu``'s (model, priors); FSSD built by hand with the tiny
    pyramid, as tests/test_family_train.py builds it."""
    if jcfg.MODEL.SSD_TYPE != "FSSD":
        model, priors, _ = jmodel_factory("train", jcfg)
        return model, priors
    prior = jprior_factory(jcfg)
    jcfg.MODEL.NUM_PRIOR = prior.num_priors
    dtype = jnp.dtype(jcfg.TPU.COMPUTE_DTYPE)
    model = JFSSD(backbone=JVGG16(dtype=dtype),
                  num_classes=jcfg.MODEL.NUM_CLASSES,
                  num_priors=tuple(prior.num_priors),
                  pyramid_spec=TINY_PYRAMID, dtype=dtype)
    dims = jprobe_layer_dims(model, jcfg.MODEL.IMAGE_SIZE)
    return model, jnp.asarray(prior(dims))


def _pair_states(case, monkeypatch, dtype="float32"):
    """Both packages' train states and steps for one tiny case, holding
    the same variables (batch norms drawn at random), the port's config
    and its feature-map dims. In ``float64`` (inside
    ``fp.odtpu_float64``) the variables are float32 values widened on
    both sides, so that the two start from the same bits."""
    ssd_type, base, bn = case
    jcfg = tiny_cfg(jdefault_cfg(), *case)
    cfg = tiny_cfg(default_cfg(), *case)
    for c in (jcfg, cfg):
        c.TPU.COMPUTE_DTYPE = dtype
    if ssd_type == "FSSD":
        monkeypatch.setattr(fssd, "FSSD300_PYRAMID", TINY_PYRAMID)
    jmodel, jpriors = _jax_model(jcfg)
    jstate, tx = jtrain.create_train_state(jmodel, jcfg)
    variables = fp.random_norms({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats})
    if dtype == "float64":
        variables = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64),
            variables)
        jstate = jstate.replace(opt_state=tx.init(variables["params"]))
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables.get("batch_stats", {}))
    jstep = jtrain.make_train_step(jmodel, jpriors, jcfg, tx, donate=False)

    state, priors = create_train_state(cfg, "cpu")
    load_strict(state.model, from_odtpu_params(fp.flat_variables(variables),
                                               state.model))
    np.testing.assert_array_equal(priors.numpy(), np.asarray(jpriors))
    if dtype == "float64":
        state.model.double()
        priors = priors.double()
    return (jstate, jstep, state, make_train_step(priors, cfg), cfg,
            probe_layer_dims(cfg))


NARROW = [("FPN", "vgg16", False), ("FSSD", "vgg16", False),
          ("SSD", "drn_d_22", False), ("DRN_SSD", "drn_d_22", False),
          ("SSD", "vgg16", True)]


@pytest.mark.parametrize("case", NARROW,
                         ids=["fpn", "fssd", "ssd_drn22", "drnssd",
                              "ssd_vgg16_bn"])
def test_narrow_train_step_matches_odtpu(case, monkeypatch):
    jstate, jstep, state, step, cfg, dims = _pair_states(case, monkeypatch)
    images, boxes, labels = narrow_batch(cfg, dims)
    unused = unused_params(case, state.model)
    _, updates, stats, _ = fp.check_train_step(
        jstate, jstep, state, step, images, boxes, labels, update_tol=1e-2,
        unused=unused)
    assert bool(stats) == (case != ("FPN", "vgg16", False))
    # the reading PERF.md quotes (pytest -s)
    print("{}: largest float32 update error {:.3g}".format(
        case, max(updates.values())))


def narrow_batch(cfg, dims):
    """The narrow steps' batch: seeded float images in [-1, 1] and
    :func:`fp.scale_boxes`'s GT."""
    images = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3))
    return (images.astype(np.float32),) + fp.scale_boxes(cfg, dims, 2,
                                                         extra=1)


def unused_params(case, model):
    """DRN_SSD's four sources end at layer7: the layers past it feed
    nothing, in odtpu too."""
    return [k for k, _ in model.named_parameters()
            if case[0] == "DRN_SSD" and k.startswith(tuple(
                "backbone.layer{}.".format(i) for i in range(8, 12)))]


def _tiny_voc_loaders(root, cfg, out):
    """The tree's images at 64x64, as one batch of 2 to train on and as
    the test set."""
    images = {}

    def reader(path):
        if path not in images:
            images[path] = cv2.resize(cv2.imread(path), (64, 64))
        return images[path]

    sets = (("2007", "test"),)
    train = DetLoader(VOCDetection(root, sets, reader=reader),
                      NetworkInput((64, 64)), batch_size=2, drop_last=True,
                      num_workers=1)
    test = DetLoader(VOCDetection(root, sets, reader=reader),
                     NetworkInput((64, 64)), batch_size=2, num_workers=1)
    return train, EvalVOC(test, cfg, str(out / "eval"))


class _Watch:
    """An ``EvalVOC`` stand-in that records, around each validation, the
    model's mode and running statistics, and the eval step's rows on one
    batch beside those of a copy of the model put in ``eval()``."""

    def __init__(self, solver, cfg, images):
        self.solver, self.cfg, self.images = solver, cfg, images
        self.seen, self.last_timing = [], {}

    def validate(self, eval_fn, tb_writer=None):
        model = eval_fn.model
        before = {k: v.clone() for k, v in model.state_dict().items()}
        mode = model.training
        out = self.solver.validate(eval_fn, tb_writer)
        self.last_timing = self.solver.last_timing
        rows = eval_fn(self.images)["rows"]
        by_hand = copy.deepcopy(model).eval()
        want = make_eval_step(by_hand, eval_fn.priors, self.cfg)(
            self.images)["rows"]
        self.seen.append(dict(
            mode=(mode, model.training),
            stats_equal=all(torch.equal(v, model.state_dict()[k])
                            for k, v in before.items()),
            rows_equal=torch.equal(rows, want),
            rows_kept=int((rows[..., 0] > 0).sum())))
        return out


def test_fit_validates_a_batch_normed_model_in_eval_mode(tmp_path):
    """SSD over VGG16-BN at 64x64 through ``fit``: two steps, then its
    validation. Before the fix the validation normalised with the eval
    batch's statistics and moved the running ones."""
    make_voc(str(tmp_path / "voc"), n_images=2, seed=5)
    cfg = tiny_cfg(default_cfg(), "SSD", batch_norm=True)
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    cfg.DATASET.TEST_SETS = (("2007", "test"),)
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    cfg.TRAIN.MAX_ITER = cfg.TRAIN.EVAL_ITER = cfg.TRAIN.SAVE_ITER = 2
    cfg.TRAIN.LOG_LOSS_ITER = 1
    train, solver = _tiny_voc_loaders(str(tmp_path / "voc"), cfg, tmp_path)
    images = next(iter(solver.loader))["images"]
    watch = _Watch(solver, cfg, images)
    out = fit(cfg, train, watch, tmp_path / "run", device="cpu")
    assert out["step"] == 2 and len(watch.seen) == 1
    seen = watch.seen[0]
    assert seen["mode"] == (True, True)
    assert seen["stats_equal"] and seen["rows_equal"], seen
    assert seen["rows_kept"] > 0


def test_checkpoint_and_npz_carry_the_running_statistics(tmp_path):
    """After a step of SSD over VGG16-BN the running statistics have
    moved; a save and restore gives them back bit-equal, and
    ``to_odtpu_params`` puts them under ``__batch_stats__/``."""
    cfg = tiny_cfg(default_cfg(), "SSD", batch_norm=True)
    state, priors = create_train_state(cfg, "cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(priors, cfg)
    rng = np.random.RandomState(1)
    boxes, labels = fp.scale_boxes(cfg, [(8, 8), (4, 4), (2, 2), (1, 1)],
                                   2)
    step(state, torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3))
                                 .astype(np.float32)),
         torch.from_numpy(boxes), torch.from_numpy(labels))
    sd = state.model.state_dict()
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 2 * 15  # VGG16-BN's 15 convs
    assert all(not torch.equal(sd[k], init[k]) for k in running)

    ck = Checkpointer(tmp_path / "ckpt")
    ck.save(state.step, state)
    fresh, _ = create_train_state(cfg, "cpu", seed=1)
    ck.restore(fresh)
    assert fresh.step == 1
    for k in running:
        assert torch.equal(fresh.model.state_dict()[k], sd[k]), k
    flat = to_odtpu_params(sd)
    stats = sorted(k for k in flat if k.startswith(BATCH_STATS_PREFIX))
    assert len(stats) == 30
    assert stats[0] == "__batch_stats__/backbone/conv1_1/bn/mean"
    np.testing.assert_array_equal(
        flat["__batch_stats__/backbone/conv1_1/bn/var"],
        sd["backbone.conv1_1.bn.running_var"].numpy())


@pytest.mark.parametrize("name,yml", [
    ("rfbnet300_vgg16_voc", "cfgs/tests/rfbnet_ft.yml"),
    ("refinedet320_vgg16_voc", "cfgs/tests/refinedet_ft.yml")])
def test_basenet_moves_the_flagship_trunk(name, yml):
    """cfgs/tests/{rfbnet,refinedet}_ft.yml's protocol: ``--basenet`` with
    the flagship SSD300 npz moves what ``odtpu``'s ``load_model_npz``
    moves, by path and shape: the 15 VGG convs (30 arrays), and into
    RFBNet300 also the 18 head tensors whose shape matches SSD300's
    (the yml says the heads stay at init; they do not, in odtpu either).
    Everything else keeps its init."""
    if not osp.isfile(FLAGSHIP):
        pytest.skip("the flagship checkpoint is not in this checkout")
    jcfg = jload_cfg(yml)
    jmodel, _, _ = jmodel_factory("train", jcfg)
    shapes = jax.eval_shape(lambda: init_model(jmodel, jcfg))["params"]
    _, want, _ = jload_model_npz(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
        FLAGSHIP)

    state, _ = create_train_state(load_cfg(name), "cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    scheme, loaded, _ = load_basenet(state.model, FLAGSHIP)
    assert scheme == "full-path" and sorted(loaded) == sorted(want)
    trunk = [k for k in loaded if k.startswith("backbone/")]
    assert len(trunk) == 30
    assert len(loaded) == (48 if name.startswith("rfbnet") else 30)
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, init[k])]
    assert sorted(moved) == sorted(
        k.replace("/", ".").replace("kernel", "weight") for k in loaded)


@pytest.mark.parametrize("name", sorted(CFGS) + ["ssd_vgg16_bn"])
def test_every_configuration_builds_a_train_state(name):
    bn = name == "ssd_vgg16_bn"
    cfg = load_cfg("ssd_vgg16_voc" if bn else name)
    cfg.MODEL.BATCH_NORM = bn
    state, priors = create_train_state(cfg, "cpu")
    assert state.model.training and state.step == 0
    step = make_train_step(priors, cfg)
    assert step.refinedet == (cfg.MODEL.SSD_TYPE == "RefineDet")
    assert priors.shape[0] == sum(
        h * w * n for (h, w), n in zip(probe_layer_dims(cfg),
                                       cfg.MODEL.NUM_PRIOR))
