"""Shared checks of the port's detector families against ``odtpu`` on the
CPU, at full width, batch 1, float32 (imported by the
``tests/test_torch_*`` family files).

The JAX side's variables (``odtpu.models.init_model``: params and, for
the batch-normed families, batch_stats) are carried across with
``from_odtpu_params``. Tolerances, as tests/test_torch_model.py holds
SSD300 and for the same reasons: loc and the raw conf logits within 1e-4
of their largest value (random-init activations at raw pixel scale grow
through the net, and the two frameworks sum each conv in another order).
A train step (:func:`check_train_step`) is held as
tests/test_torch_train.py holds SSD300's.
"""

import contextlib
import copy
import importlib
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from odtpu.models import init_model, model_factory as jmodel_factory
from odtpu.parallel import make_eval_step as jmake_eval_step
from odtpu.utils.config import load_cfg as jload_cfg

from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.models import model_factory
from odtpu_torch.utils.checkpoint import (BATCH_STATS_PREFIX,
                                          from_odtpu_params, load_strict,
                                          to_odtpu_params)
from odtpu_torch.utils.config import CFGS, load_cfg

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)

MEANS = np.float32([104, 117, 123])


def jax_cfg(name):
    """``odtpu``'s config of one of the port's named configurations, from
    its yml (DRN_SSD, which has none, as tests/test_model_zoo.py builds
    it)."""
    yml = CFGS[name]
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


def odtpu_variables(state_dict):
    """The port's ``state_dict`` as ``odtpu``'s flax variables
    (``to_odtpu_params``; batch stats under ``batch_stats``)."""
    cols = {"params": {}, "batch_stats": {}}
    for key, value in to_odtpu_params(state_dict).items():
        col = "params"
        if key.startswith(BATCH_STATS_PREFIX):
            col, key = "batch_stats", key[len(BATCH_STATS_PREFIX):]
        cols[col][tuple(key.split("/"))] = jnp.asarray(value)
    return {c: flax.traverse_util.unflatten_dict(d)
            for c, d in cols.items() if d}


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


def scale_boxes(cfg, dims, batch, seed=0, extra=3, G=60):
    """Padded GT [batch, G, 4], [batch, G] for ``cfg`` at feature-map dims
    ``dims``: ``extra`` + b random boxes in image b, then one box for each
    prior scale (MIN_SIZES over the image side) on a seeded cell of that
    scale's map, so that every head gets a gradient."""
    rng = np.random.RandomState(seed)
    side = float(cfg.MODEL.IMAGE_SIZE[0])
    scales = [float(m) / side for m in cfg.MODEL.MIN_SIZES]
    boxes = np.zeros((batch, G, 4), np.float32)
    labels = np.full((batch, G), -1, np.int32)
    for b in range(batch):
        n = extra + b
        xy = rng.uniform(0.05, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.35, (n, 2))
        boxes[b, :n] = np.concatenate([xy, xy + wh], 1)
        for i, (s, (cells, _)) in enumerate(zip(scales, dims)):
            c = (rng.randint(cells, size=2) + 0.5) / cells
            half = s * rng.uniform(0.85, 1.15, 2) / 2
            boxes[b, n + i] = np.clip(np.concatenate([c - half, c + half]),
                                      0.0, 1.0)
        labels[b, :n + len(scales)] = rng.randint(0, 20, n + len(scales))
    return boxes, labels


def _momentum(opt_state):
    """The SGD momentum (optax's trace) of an ``odtpu`` optimizer state,
    as a flat map."""
    import optax
    trace, = [s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return flat_variables({"params": trace})


def check_train_step(jstate, jstep, state, step, images, boxes, labels,
                     draws=None, update_tol=1e-3, stats_tol=1e-5,
                     unused=()):
    """One SGD step of ``odtpu`` (``jstep`` on ``jstate``) and of the
    port (``step`` on ``state``, which holds the same variables) on the
    same batch (``draws``: the photometric parameters ``odtpu`` drew, fed
    to the port). Holds num_pos equal, the losses within rtol 1e-4, every
    parameter's update within a relative L2 error of ``update_tol``, every
    running statistic after the step within ``stats_tol``, tensor by
    tensor in ``odtpu``'s flat names, and a gradient on every
    parameter but the ``unused`` ones (state-dict names), which get none.

    The update is read before the learning rate scales it: the momentum
    after the first step, the clipped gradient plus the weight decay
    (optax's trace, torch's momentum buffer). The difference of the
    weights before and after would round it to the weights' ulp: a norm's
    scale near 1 moves by ~1e-6 at LR 1e-3, 8 ulps. A tensor's error is
    taken relative to its update, or to 1e-3 of its layer's largest
    update where its own is smaller: an RFB branch's last norm feeds a
    1x1 conv and a train-mode norm, which removes every channel's mean,
    so that norm's bias has no gradient in exact arithmetic, and its
    update (weight decay, 1e-8) is rounding noise on both sides. A
    running variance is held in relative L2, a running mean in units of
    its channel's running standard deviation (a batch mean near 0 has
    no relative precision). Returns (port metrics, {name: update
    error}, {name: statistics error})."""
    from odtpu_torch.utils.checkpoint import to_odtpu_params

    assert state.step == 0 and int(jstate.step) == 0
    jnew, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(boxes),
                     jnp.asarray(labels))
    m = step(state, torch.from_numpy(images), torch.from_numpy(boxes),
             torch.from_numpy(labels), aug_params=draws)
    after = to_odtpu_params(state.model.state_dict())
    new = flat_variables({"params": jnew.params,
                          "batch_stats": jnew.batch_stats})
    assert sorted(after) == sorted(new)
    assert int(m["num_pos"]) == int(jm["num_pos"]) > 0
    for k in ("loss", "loss_loc", "loss_conf"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    want = _momentum(jnew.opt_state)
    updates = update_errors(state, want)
    stats = chip_smoke.stats_errors(
        chip_smoke.running_stats(state.model),
        from_odtpu_params({k: v for k, v in new.items()
                           if k.startswith("__batch_stats__/")}))
    no_grad = [k for k, p in state.model.named_parameters()
               if p.grad is None or not bool(p.grad.any())]
    assert sorted(no_grad) == sorted(unused), no_grad
    worst = max(updates, key=updates.get)
    assert updates[worst] <= update_tol, (worst, updates[worst])
    if stats:
        worst = max(stats, key=stats.get)
        assert stats[worst] <= stats_tol, (worst, stats[worst])
    return m, updates, stats, want


def update_errors(state, want):
    """{name: error} of the update of each tensor in the port's ``state``
    (its momentum after one step) against ``want`` (``odtpu``'s, by flat
    name): ``chip_smoke.momentum_errors``, relative to the larger of that
    update's norm and 1e-3 of its layer's largest (see
    :func:`check_train_step`)."""
    opt = state.optimizer.state
    got = {name: opt[p]["momentum_buffer"].double()
           for name, p in state.model.named_parameters()}
    ref = from_odtpu_params(want)
    assert sorted(got) == sorted(ref)
    return chip_smoke.momentum_errors(
        got, {k: v.double() for k, v in ref.items()})


def float64_update_errors(cfg, weights, images, boxes, labels, want,
                          num_pos, draws=None):
    """The port's step of ``cfg`` from ``weights`` taken in float64 on the
    same batch (numpy arrays), its updates held by :func:`update_errors`
    to ``want`` (``odtpu``'s float32 step) within 1e-3, its positives
    equal to ``num_pos``. Returns the errors."""
    from odtpu_torch.train_step import create_train_state, make_train_step

    cfg = copy.deepcopy(cfg)
    cfg.TPU.COMPUTE_DTYPE = "float64"
    state, priors = create_train_state(cfg, "cpu")
    load_strict(state.model, weights)
    state.model.double()
    step = make_train_step(priors.double(), cfg)
    m = step(state, torch.from_numpy(images), torch.from_numpy(boxes),
             torch.from_numpy(labels), aug_params=draws)
    assert int(m["num_pos"]) == num_pos
    errors = update_errors(state, want)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= 1e-3, (worst, errors[worst])
    return errors


# odtpu's modules that fix a computation at float32 whatever the compute
# dtype: batch norms, L2Norm, the heads' outputs, the loss
_FLOAT32_MODULES = ("layers.losses", "models.common", "models.fpn",
                    "models.fssd", "models.refinedet", "models.rfbnet",
                    "models.ssd")


@contextlib.contextmanager
def odtpu_float64():
    """JAX in float64 (``jax.enable_x64``), and ``odtpu``'s models with
    their float32 casts widened to float64, so that its train step with
    ``COMPUTE_DTYPE`` float64 is a float64 step: the reference against
    which the port's float64 step (its model, distortion and loss in
    float64) shows what rounding in two float32 steps cannot."""
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.float32 = jnp.float64
    mods = [importlib.import_module("odtpu." + m)
            for m in _FLOAT32_MODULES]
    saved = [m.jnp for m in mods]
    with jax.enable_x64(True):
        try:
            for m in mods:
                m.jnp = wide
            yield
        finally:
            for m, j in zip(mods, saved):
                m.jnp = j


def full_width_step(name, npz, batch=2):
    """One SGD step of configuration ``name`` at full width from the
    trained ``npz`` (params and ``__batch_stats__``): :func:`scale_boxes`
    GT, each box painted into its :func:`synth_image` (uint8, the
    photometric distortion on the device, ``odtpu``'s draws fed to the
    port).

    ``odtpu``'s float32 step is the reference. The port takes the step
    in float64, held by :func:`update_errors` within 1e-3, and in
    float32, held by :func:`check_train_step` with updates within 1e-2:
    the ReLUs right after train-mode norms sit at the centre of the
    normalised values, where rounding flips their signs, so two float32
    steps of RFBNet300 differ by some 1e-3 per tensor, while the port's
    float64 step holds ``odtpu``'s float32 one to 1e-4. Returns (npz tensors loaded, :func:`check_train_step`'s
    result, the float64 update errors, the port's train step)."""
    from odtpu.parallel import train as jtrain
    from odtpu.utils.checkpoint import load_variables_npz
    from odtpu_torch.train_step import create_train_state, make_train_step
    from odtpu_torch.utils.checkpoint import load_odtpu_npz
    from test_torch_loss import jax_draws

    jcfg, cfg = jax_cfg(name), load_cfg(name)
    for c in (jcfg, cfg):
        c.TPU.COMPUTE_DTYPE = "float32"
        c.DATASET.DEVICE_PHOTOMETRIC = True
    jmodel, jpriors, _ = jmodel_factory("train", jcfg)
    jstate, tx = jtrain.create_train_state(jmodel, jcfg)
    variables, loaded, skipped = load_variables_npz(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, npz)
    assert not skipped
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables.get("batch_stats", {}))
    jstep = jtrain.make_train_step(jmodel, jpriors, jcfg, tx, donate=False)

    weights = load_odtpu_npz(npz)
    state, priors = create_train_state(cfg, "cpu")
    load_strict(state.model, weights)
    step = make_train_step(priors, cfg)
    from odtpu_torch.models import probe_layer_dims
    boxes, labels = scale_boxes(cfg, probe_layer_dims(cfg), batch)
    images = np.concatenate([synth_image(cfg.MODEL.IMAGE_SIZE, s)
                             for s in range(batch)])
    size = np.array(cfg.MODEL.IMAGE_SIZE[::-1] * 2)
    palette = np.random.RandomState(99).randint(30, 255, (20, 3))
    for b in range(batch):
        for box, label in zip(boxes[b], labels[b]):
            if label >= 0:
                x1, y1, x2, y2 = (box * size).astype(int)
                images[b, y1:y2, x1:x2] = palette[label]
    draws = jax_draws(jax.random.fold_in(jax.random.PRNGKey(17), 0), batch)
    checked = check_train_step(jstate, jstep, state, step, images, boxes,
                               labels, draws=draws, update_tol=1e-2)
    errors64 = float64_update_errors(cfg, weights, images, boxes, labels,
                                     checked[3], int(checked[0]["num_pos"]),
                                     draws)
    # the readings PERF.md quotes (pytest -s)
    print("{}: largest update error against odtpu's float32 step, the "
          "port's float32 step {:.3g}, its float64 step {:.3g}".format(
              name, max(checked[1].values()), max(errors64.values())))
    return len(loaded), checked, errors64, step
