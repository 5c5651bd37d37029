"""Shared checks of the port's detector families against ``odtpu`` on the
CPU, at full width, batch 1, float32 (imported by the
``tests/test_torch_*`` family files).

The JAX side's variables (``odtpu.models.init_model``: params and, for
the batch-normed families, batch_stats) are carried across with
``from_odtpu_params``. Tolerances, as tests/test_torch_model.py holds
SSD300 and for the same reasons: loc and the raw conf logits within 1e-4
of their largest value (random-init activations at raw pixel scale grow
through the net, and the two frameworks sum each conv in another order).
"""

import copy

import flax
import jax.numpy as jnp
import numpy as np
import torch

from odtpu.models import init_model, model_factory as jmodel_factory
from odtpu.parallel import make_eval_step as jmake_eval_step
from odtpu.utils.config import load_cfg as jload_cfg

from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.models import model_factory
from odtpu_torch.utils.checkpoint import from_odtpu_params, load_strict
from odtpu_torch.utils.config import CFGS, load_cfg

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)

MEANS = np.float32([104, 117, 123])


def jax_cfg(name):
    """``odtpu``'s config of one of the port's named configurations, from
    its yml (DRN_SSD, which has none, as tests/test_model_zoo.py builds
    it)."""
    yml = CFGS[name][0]
    cfg = jload_cfg(yml)
    if yml is None:
        cfg.MODEL.SSD_TYPE, cfg.MODEL.BASE = "DRN_SSD", "drn_d_22"
    return cfg


def flat_variables(variables):
    """flax variables -> ``odtpu``'s flat npz map (batch stats under
    ``__batch_stats__/``, as its exports carry them)."""
    out = {}
    for col, prefix in (("params", ""), ("batch_stats", "__batch_stats__/")):
        for k, v in flax.traverse_util.flatten_dict(
                variables.get(col, {})).items():
            out[prefix + "/".join(k)] = np.asarray(v)
    return out


def build_pair(name, dtype="float32", batch_norm=False):
    """Both sides of one configuration at init (``batch_norm`` sets
    ``MODEL.BATCH_NORM``): a dict of jcfg, jmodel, jpriors, jdims,
    variables, cfg, model (eval mode, seeded weights), priors, dims."""
    jcfg = jax_cfg(name)
    cfg = load_cfg(name)
    for c in (jcfg, cfg):
        c.TPU.COMPUTE_DTYPE = dtype
        c.MODEL.BATCH_NORM = batch_norm
    jmodel, jpriors, jdims = jmodel_factory("eval", jcfg)
    variables = init_model(jmodel, jcfg)
    model, priors, dims = model_factory("eval", cfg, device="cpu")
    model.eval()
    return dict(jcfg=jcfg, jmodel=jmodel, jpriors=jpriors, jdims=jdims,
                variables=variables, cfg=cfg, model=model, priors=priors,
                dims=dims)


class Pairs:
    """``pairs(name, **kw)``: :func:`build_pair`'s result, built once per
    instance (a module-scoped fixture holds one)."""

    def __init__(self):
        self._built = {}

    def __call__(self, name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in self._built:
            self._built[key] = build_pair(name, **kw)
        return self._built[key]


def check_dims_and_priors(pair):
    assert pair["dims"] == [tuple(d) for d in pair["jdims"]]
    np.testing.assert_array_equal(pair["priors"].numpy(),
                                  np.asarray(pair["jpriors"]))


def images(size, seed=0):
    """[1, H, W, 3] seeded uint8 noise."""
    h, w = size
    return np.random.RandomState(seed).randint(0, 256, (1, h, w, 3),
                                               dtype=np.uint8)


def synth_image(size, seed):
    """[1, H, W, 3] uint8 noise with three solid rectangles in
    tests/synth.py's class colours, the kind of image the in-repo
    checkpoints were trained on."""
    palette = np.random.RandomState(99).randint(30, 255, (20, 3))
    rng = np.random.RandomState(seed)
    h, w = size
    img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    for _ in range(3):
        x, y = rng.randint(0, w - 100), rng.randint(0, h - 100)
        bw, bh = rng.randint(40, 100, 2)
        img[y:y + bh, x:x + bw] = palette[rng.randint(20)]
    return img[None]


_NORMS = ("bn", "fusion_bn")


def random_norms(variables, seed=0):
    """A copy of flax ``variables`` whose batch norms (``bn``,
    ``fusion_bn``) have random scale and variance in 0.5..1.5 and random
    bias and mean in +-0.5: at init (1, 0, 0, 1) a norm is the identity
    to within 5e-6, and a port that left it out or put it in the wrong
    place would pass."""
    rng = np.random.RandomState(seed)
    out = {}
    for col, tree in variables.items():
        flat = flax.traverse_util.flatten_dict(tree)
        for k, v in flat.items():
            if len(k) > 1 and k[-2] in _NORMS:
                low = 0.5 if k[-1] in ("scale", "var") else -0.5
                flat[k] = jnp.asarray(low + rng.uniform(size=v.shape),
                                      v.dtype)
        out[col] = flax.traverse_util.unflatten_dict(flat)
    return out


def check_forward(pair):
    """The full-width forward from ``odtpu``'s init weights, their batch
    norms' statistics drawn at random (:func:`random_norms`) (phase
    "train": raw logits), every output within 1e-4 of its largest
    value. Returns the outputs' shapes."""
    variables = random_norms(pair["variables"])
    flat = flat_variables(variables)
    sd = from_odtpu_params(flat, pair["model"])
    load_strict(pair["model"], sd)
    x = (images(pair["cfg"].MODEL.IMAGE_SIZE).astype(np.float32)
         - MEANS)[..., ::-1].copy()
    want = pair["jmodel"].apply(variables, jnp.asarray(x),
                                phase="train", train=False)
    with torch.no_grad():
        got = pair["model"](torch.from_numpy(x), phase="train")
    assert len(got) == len(want)
    P = pair["priors"].shape[0]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[:2] == (1, P)
        assert g.dtype == torch.float32 and np.isfinite(w).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    return [tuple(g.shape) for g in got]


def check_init(pair, seed=3):
    """The port's seeded init against ``odtpu``'s init_model, tensor by
    tensor: each kernel's std within 5 %, its mean within 5 % of the std
    of 0, and its largest value at the same multiple of the std (the
    same truncation, or uniform); zero kernels (RefineDet's ARM loc
    heads), zero biases, the L2Norm scales, batch norm's scale 1, bias 0
    and running mean 0, variance 1 exactly. Returns the count of kernels
    checked.

    The largest value of a kernel of n draws lies within ~0.2 % of the
    cut, so that multiple, ~2.27 for flax's truncated normals and 1.73
    for a uniform (an untruncated normal gives ~4), varies with the
    sample std, whose relative error is ~0.6 / sqrt(n) for a normal cut
    at 2 std. The two multiples are held within the larger of 0.05 and 5
    of those errors (0.11 at n = 8,192: RFBNet512's 1x1 convs on 256
    channels; a fixed 0.05, which SSD300's 35 kernels meet, is 2.6 such
    errors there and fails one of its 100 kernels)."""
    model, _, _ = model_factory("eval", copy.deepcopy(pair["cfg"]),
                                device="cpu", seed=seed)
    sd = model.state_dict()
    n_kernels = 0
    for key, want in flat_variables(pair["variables"]).items():
        (name, _), = from_odtpu_params({key: want}).items()
        got = sd[name].numpy()
        if not key.endswith("/kernel"):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        n_kernels += 1
        if not want.any():
            assert not got.any(), key
            continue
        assert abs(got.std() / want.std() - 1) <= 0.05, key
        assert abs(got.mean()) <= 0.05 * want.std(), key
        ratio = np.abs(want).max() / want.std()
        spread = 5 * ratio * 0.6 * (1 / got.size + 1 / want.size) ** 0.5
        assert abs(np.abs(got).max() / got.std() - ratio) <= max(
            0.05, spread), key
    return n_kernels


def check_eval_step(pair, variables):
    """The port's eval step (with the weights ``pair["model"]`` holds)
    against ``odtpu``'s ``make_eval_step`` on ``variables``, on two
    :func:`synth_image` images: the same classes and ``dropped``, rows
    within 1e-5, as the flagship SSD300 test holds them."""
    jstep = jmake_eval_step(pair["jmodel"], pair["jpriors"], pair["jcfg"],
                            compact=True)
    step = make_eval_step(pair["model"], pair["priors"], pair["cfg"])
    for seed in (0, 1):
        u8 = synth_image(pair["cfg"].MODEL.IMAGE_SIZE, seed)
        want = jstep.raw_step(variables["params"],
                              variables.get("batch_stats", {}),
                              jstep.priors, jnp.asarray(u8))
        got = step(torch.from_numpy(u8))
        rows = np.asarray(want["rows"])
        assert 0 < (rows[..., 0] > 0).sum() < 200
        np.testing.assert_array_equal(got["rows"][..., 5].numpy(),
                                      rows[..., 5])
        np.testing.assert_array_equal(got["dropped"].numpy(),
                                      np.asarray(want["dropped"]))
        np.testing.assert_allclose(got["rows"].numpy(), rows, rtol=0,
                                   atol=1e-5)
