"""The port's SSD300-VGG16, weight import and eval step against the JAX
package on the CPU, at full width, batch 1, 300x300, float32.

The JAX side's parameters (odtpu ``init_model``) are carried across with
``from_odtpu_params``. Tolerances, and why:
- loc: within 1e-4 of the largest |loc|. Random-init activations at raw
  pixel scale grow through 23 convs (|loc| reaches the hundreds), and the
  two frameworks sum each conv in another order, so the error is
  relative to the output's scale;
- conf logits: the same, for the same reason. The softmaxed conf is held
  to atol 1e-4 where the logits are near unit scale (the eval-step test):
  at odtpu's raw init the logits reach the hundreds, and a 1e-6 relative
  rounding difference there moves a probability by ~1e-4 on its own;
- VGG16 taps against the reference golden: rtol 1e-4, atol 1e-3, the
  tolerance tests/test_backbone_import.py holds odtpu to;
- eval-step rows from the same loc/conf: atol 1e-6, as the detect tests.
"""

import os.path as osp

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.models import init_model, model_factory as jmodel_factory
from odtpu.parallel import make_eval_step as jmake_eval_step
from odtpu.utils.checkpoint import load_model_npz as jload_model_npz
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.models import (VGG16, create_model, model_factory,
                                probe_layer_dims)
from odtpu_torch.utils.checkpoint import from_odtpu_params, load_odtpu_npz
from odtpu_torch.utils.config import default_cfg

from test_backbone_import import GOLDEN as VGG_GOLDEN, make_weights
from torch_tmp import drop_module_tmp  # noqa: F401

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)

# trained SSD300 weights (tests/synth.py images), 71 float16 tensors
FLAGSHIP = osp.join(osp.dirname(__file__), "..", "history", "tests",
                    "flagship_r4", "flagship_r4_iter6000_f16.npz")


def _flat(params):
    return {"/".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(params).items()}


@pytest.fixture(scope="module")
def models():
    jcfg = jdefault_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel, jpriors, jdims = jmodel_factory("eval", jcfg)
    params = init_model(jmodel, jcfg)["params"]
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model, priors, dims = model_factory("eval", cfg, device="cpu")
    model.eval()
    return dict(jcfg=jcfg, jmodel=jmodel, jpriors=jpriors, jdims=jdims,
                params=params, cfg=cfg, model=model, priors=priors,
                dims=dims)


def _images(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (1, 300, 300, 3), dtype=np.uint8)


def test_vgg16_matches_reference_golden():
    g = np.load(VGG_GOLDEN)
    vgg = VGG16(dtype=torch.float32)
    weights = make_weights(seed=int(g["seed"]))
    vgg.load_state_dict({name.replace(".", ".conv."): torch.from_numpy(w)
                         for name, w in weights.items()})
    with torch.no_grad():
        (c43, c7), final = vgg(torch.from_numpy(g["x"]).permute(0, 3, 1, 2))
    assert final is c7
    for got, key in ((c43, "conv4_3"), (c7, "conv7")):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), g[key],
                                   rtol=1e-4, atol=1e-3)


def test_factory_dims_and_priors_match_odtpu(models):
    assert models["dims"] == [tuple(d) for d in models["jdims"]]
    np.testing.assert_array_equal(models["priors"].numpy(),
                                  np.asarray(models["jpriors"]))
    assert models["priors"].shape == (8732, 4)


def test_full_width_forward_matches_flax(models):
    flat = _flat(models["params"])
    assert len(flat) == 71
    sd = from_odtpu_params(flat, models["model"])
    assert len(sd) == 71  # every key consumed, none missing
    models["model"].load_state_dict(sd, strict=True)

    x = (_images().astype(np.float32)
         - np.float32([104, 117, 123]))[..., ::-1].copy()
    jloc, jconf = models["jmodel"].apply({"params": models["params"]},
                                         jnp.asarray(x), phase="train")
    with torch.no_grad():
        loc, conf = models["model"](torch.from_numpy(x), phase="train")
    jloc, jconf = np.asarray(jloc), np.asarray(jconf)
    assert loc.shape == jloc.shape == (1, 8732, 4)
    assert conf.shape == jconf.shape == (1, 8732, 21)
    for got, want in ((loc, jloc), (conf, jconf)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_eval_step_matches_odtpu(models):
    """uint8 in, rows out. conv1_1's kernel is scaled down by 64 on both
    sides so the random loc head stays where exp() in decode is finite."""
    params = flax.core.unfreeze(models["params"])
    k = params["backbone"]["conv1_1"]["conv"]["kernel"]
    params["backbone"]["conv1_1"]["conv"]["kernel"] = k / 64.0
    models["model"].load_state_dict(
        from_odtpu_params(_flat(params), models["model"]))
    u8 = _images(1)

    jstep = jmake_eval_step(models["jmodel"], models["jpriors"],
                            models["jcfg"])
    want = jstep.raw_step(params, {}, jstep.priors, jnp.asarray(u8))
    x = (u8.astype(np.float32) - np.float32([104, 117, 123]))[..., ::-1]
    jloc, jconf = models["jmodel"].apply({"params": params},
                                         jnp.asarray(x), phase="eval")

    step = make_eval_step(models["model"], models["priors"], models["cfg"])
    loc, conf = step.forward(torch.from_numpy(u8))
    scale = np.abs(np.asarray(jloc)).max()
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-4)
    got = step.detect(torch.from_numpy(np.array(jloc)),
                      torch.from_numpy(np.array(jconf)))
    rows = np.asarray(want["rows"])
    assert rows.shape == (1, 200, 6) and np.isfinite(rows).all()
    assert (rows[..., 0] > 0).sum() > 100
    np.testing.assert_allclose(got["rows"].numpy(), rows, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["dropped"].numpy(),
                                  np.asarray(want["dropped"]))
    end_to_end = step(torch.from_numpy(u8))
    assert end_to_end["rows"].shape == (1, 200, 6)
    assert torch.isfinite(end_to_end["rows"]).all()


def test_compact_rows_cap_is_honoured(models):
    cfg = default_cfg()
    cfg.EVAL.COMPACT_ROWS = 50
    step = make_eval_step(models["model"], models["priors"], cfg)
    rng = np.random.RandomState(2)
    loc = torch.from_numpy((rng.randn(2, 8732, 4) * 0.5).astype(np.float32))
    conf = torch.softmax(torch.from_numpy(
        rng.randn(2, 8732, 21).astype(np.float32)), -1)
    out = step.detect(loc, conf)
    full = make_eval_step(models["model"], models["priors"],
                          default_cfg()).detect(loc, conf)
    assert out["rows"].shape == (2, 50, 6)
    torch.testing.assert_close(out["rows"], full["rows"][:, :50], rtol=0,
                               atol=0)
    assert (out["dropped"] - full["dropped"] == 150).all()


def test_from_odtpu_params_is_strict(models, tmp_path):
    flat = _flat(models["params"])
    with pytest.raises(KeyError, match="no place"):
        from_odtpu_params({**flat, "__batch_stats__/x/mean": np.zeros(3)})
    with pytest.raises(KeyError, match="no place"):
        from_odtpu_params({**flat, "head/loc_9/conv/kernel":
                           np.zeros((3, 3, 4, 4))}, models["model"])
    short = dict(flat)
    del short["l2norm/scale"]
    with pytest.raises(KeyError, match="missing"):
        from_odtpu_params(short, models["model"])
    path = tmp_path / "ssd300.npz"
    np.savez(path, **{k: v.astype(np.float16) for k, v in flat.items()})
    sd = load_odtpu_npz(path, models["model"])
    np.testing.assert_array_equal(
        sd["backbone.conv1_1.conv.weight"].numpy(),
        flat["backbone/conv1_1/conv/kernel"].astype(np.float16)
        .astype(np.float32).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("ssd_type,base", [("FPN", "vgg16"),
                                           ("SSD", "drn_d_22")])
def test_unported_families_raise(ssd_type, base):
    """The families once refused by the train entry points now train:
    one float32 step at batch 1 from the seeded init, every loss finite,
    num_pos > 0, the weights moved (and, over DRN-D-22, the running
    statistics of its batch norms)."""
    cfg = default_cfg()
    cfg.MODEL.SSD_TYPE, cfg.MODEL.BASE = ssd_type, base
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    assert create_model(cfg)[0] is not None
    state, priors = create_train_state(cfg, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -100, 100, (1, 300, 300, 3)).astype(np.float32))
    boxes = torch.tensor([[[0.2, 0.2, 0.7, 0.7]]])
    metrics = make_train_step(priors, cfg)(state, x, boxes,
                                           torch.tensor([[3]]))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert int(metrics["num_pos"]) > 0 and state.step == 1
    after = state.model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert any(k.startswith("head.") for k in moved)
    assert any(k.endswith("running_var") for k in moved) == (base != "vgg16")


def test_probe_layer_dims_ssd300():
    assert probe_layer_dims(default_cfg()) == [
        (38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]


def test_init_weights_follow_odtpu_distributions(models):
    """Each seeded kernel's std within 5 % of odtpu's init_model (truncated
    He-normal trunk and extras, xavier-uniform heads), biases 0, the
    L2Norm scale 20."""
    flat = _flat(models["params"])
    model, _, _ = model_factory("eval", default_cfg(), device="cpu", seed=3)
    sd = model.state_dict()
    n_kernels = 0
    for key, want in flat.items():
        name = key.replace("/", ".").replace("kernel", "weight")
        got = sd[name].numpy()
        if key.endswith("kernel"):
            n_kernels += 1
            assert abs(got.std() / want.std() - 1) <= 0.05, key
            assert abs(got.mean()) <= 0.05 * want.std(), key
            # both truncated at the same multiple of the std (or uniform)
            assert abs(np.abs(got).max() / got.std()
                       - np.abs(want).max() / want.std()) <= 0.05, key
        elif key.endswith("bias"):
            assert not got.any() and not want.any(), key
        else:
            np.testing.assert_array_equal(got, want)
            assert (got == 20.0).all()
    assert n_kernels == 35


def _flagship_image(seed):
    """[1, 300, 300, 3] uint8 noise with three solid rectangles in
    tests/synth.py's class colours, the kind of image the flagship
    checkpoint was trained on."""
    palette = np.random.RandomState(99).randint(30, 255, (20, 3))
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (300, 300, 3)).astype(np.uint8)
    for _ in range(3):
        x, y = rng.randint(0, 200, 2)
        w, h = rng.randint(40, 100, 2)
        img[y:y + h, x:x + w] = palette[rng.randint(20)]
    return img[None]


def test_eval_step_on_flagship_weights_matches_odtpu(models):
    """Trained weights, float32, batch 1: the same classes and ``dropped``,
    rows within 1e-5."""
    if not osp.isfile(FLAGSHIP):
        pytest.skip("the flagship checkpoint is not in this checkout")
    params = jload_model_npz(models["params"], FLAGSHIP)[0]
    models["model"].load_state_dict(load_odtpu_npz(FLAGSHIP,
                                                   models["model"]))
    jstep = jmake_eval_step(models["jmodel"], models["jpriors"],
                            models["jcfg"], compact=True)
    step = make_eval_step(models["model"], models["priors"], models["cfg"])
    for seed in (0, 1):
        u8 = _flagship_image(seed)
        want = jstep.raw_step(params, {}, jstep.priors, jnp.asarray(u8))
        got = step(torch.from_numpy(u8))
        rows = np.asarray(want["rows"])
        kept = rows[..., 0] > 0
        assert 0 < kept.sum() < 200
        np.testing.assert_array_equal(got["rows"][..., 5].numpy(),
                                      rows[..., 5])
        np.testing.assert_array_equal(got["dropped"].numpy(),
                                      np.asarray(want["dropped"]))
        np.testing.assert_allclose(got["rows"].numpy(), rows, rtol=0,
                                   atol=1e-5)
