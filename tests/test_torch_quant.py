"""The port's int8 serving (``odtpu_torch/ops/quant.py`` and the
``set_quant`` switch) against ``odtpu.ops.quant`` and ``odtpu``'s
``quantized("int8")`` apply on the CPU.

Tolerances, and why:
- the quantizers, ``conv_int8`` and ``conv_int8_plain`` on the same
  seeded inputs: bit-equal. The scales are the same float32 operations,
  the integer sums are exact on both sides, and the rescale is one
  float32 product;
- full-width SSD300 on the flagship weights (float32, batch 1): every
  quantized conv sees the same integers, so only the float32 heads and
  L2Norm, summed in another order, round differently. loc and the conf
  logits within 1e-5 of their largest value (measured: 9.0e-7 and
  1.6e-6);
- the narrow 64x64 families: SSD, RefineDet and FPN over VGG16 with
  and without batch norm (its statistics drawn at random) and SSD over
  DRN-D-22 within 1e-3 of a quantization step (an output's largest
  value over 127), at most and on average: eval-mode batch norm
  computes flax's order, so every quantized conv sees odtpu's integers;
- int8 against float32 rows on the flagship weights:
  tests/test_quant.py's rule (the top row of each image of the same
  class, its score within 0.05, IoU >= 0.5);
- ``fit`` with ``TPU.QUANT = "int8"``: its validation's rows equal an
  int8 eval step's built by hand, exactly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.models import init_model, model_factory as jmodel_factory
from odtpu.models.common import quantized
from odtpu.ops import quant as jquant
from odtpu.utils.checkpoint import load_model_npz as jload_model_npz
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.models import Conv, model_factory, set_quant
from odtpu_torch.ops import quant
from odtpu_torch.train import fit
from odtpu_torch.utils.checkpoint import (from_odtpu_params, load_odtpu_npz,
                                          load_strict)
from odtpu_torch.utils.config import default_cfg

import torch_family_parity as fp
from test_torch_model import FLAGSHIP, _flagship_image
from synth import make_voc
from test_torch_train_families import _tiny_voc_loaders, tiny_cfg
from torch_tmp import drop_module_tmp  # noqa: F401

torch.set_num_threads(2)

MEANS = np.float32([104, 117, 123])

# name: (B, Cin, H, W, O, kernel, stride, padding, dilation)
CASES = {
    "3x3_pad1": (2, 16, 9, 9, 24, (3, 3), 1, (1, 1), 1),
    "stride2": (2, 16, 10, 10, 16, (3, 3), 2, (1, 1), 1),
    "dilation6": (1, 16, 19, 19, 16, (3, 3), 1, (6, 6), 6),
    "3x1": (2, 8, 7, 9, 16, (3, 1), 1, (1, 0), 1),
    "1x3": (2, 8, 7, 9, 16, (1, 3), 1, (0, 1), 1),
    "valid": (2, 16, 5, 5, 16, (3, 3), 1, (0, 0), 1),
    "1x1": (2, 32, 6, 6, 64, (1, 1), 1, (0, 0), 1),
    "1x1_stride2": (2, 16, 7, 7, 32, (1, 1), 2, (0, 0), 1),
    "cin3": (2, 3, 12, 12, 64, (3, 3), 1, (1, 1), 1),
    "o_not_8": (2, 16, 8, 8, 12, (3, 3), 1, (1, 1), 1),
    "b1_1x1_map": (1, 256, 1, 1, 128, (1, 1), 1, (0, 0), 1),
    "b1_valid_to_1x1": (1, 128, 3, 3, 256, (3, 3), 1, (0, 0), 1),
}


def _iou(a, b):
    """tests/test_quant.py's IoU of two (x1, y1, x2, y2) boxes."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ar = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(ar - inter, 1e-9)


def _operands(case, seed=0, zero_image=None):
    b, cin, h, w, o, k, _, _, _ = CASES[case]
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, cin, h, w) * 3).astype(np.float32)
    if zero_image is not None:
        x[zero_image] = 0.0
    wt = rng.randn(o, cin, *k).astype(np.float32)
    return x, wt


def _jax_conv(x, wt, case):
    """odtpu's conv_int8 on NCHW x and OIHW wt -> NCHW numpy."""
    _, _, _, _, _, _, s, (ph, pw), d = CASES[case]
    y = jquant.conv_int8(jnp.asarray(x.transpose(0, 2, 3, 1)),
                         jnp.asarray(wt.transpose(2, 3, 1, 0)), (s, s),
                         ((ph, ph), (pw, pw)), (d, d))
    return np.asarray(y).transpose(0, 3, 1, 2)


def _port_conv(fn, x, wt, case, cache=None, layout=torch.contiguous_format):
    _, _, _, _, _, _, s, pad, d = CASES[case]
    xt = torch.from_numpy(x).contiguous(memory_format=layout)
    return fn(xt, torch.from_numpy(wt), (s, s), pad, (d, d), torch.float32,
              cache).numpy()


def test_quantizers_are_bit_equal_to_odtpu():
    x, wt = _operands("3x3_pad1", zero_image=1)
    want_q, want_s = map(np.asarray, jquant.quantize_act_int8(
        jnp.asarray(x.transpose(0, 2, 3, 1))))
    x_q, s_x = quant.quantize_act_int8(torch.from_numpy(x))
    assert x_q.dtype == torch.int8 and s_x.shape == (2, 1, 1, 1)
    np.testing.assert_array_equal(x_q.numpy().transpose(0, 2, 3, 1), want_q)
    np.testing.assert_array_equal(s_x.numpy(), want_s)
    assert (x_q[1] == 0).all()  # the all-zero image: the 1e-12 floor
    want_q, want_s = map(np.asarray, jquant.quantize_weight_int8(
        jnp.asarray(wt.transpose(2, 3, 1, 0))))
    w_q, s_w = quant.quantize_weight_int8(torch.from_numpy(wt))
    np.testing.assert_array_equal(w_q.numpy().transpose(2, 3, 1, 0), want_q)
    np.testing.assert_array_equal(s_w.numpy(), want_s)


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_int8_is_bit_equal_to_odtpu(case):
    """Both routes, from an NCHW input and from a channels-last one (the
    card's layout, where the taps are gathered as int64 words)."""
    x, wt = _operands(case)
    want = _jax_conv(x, wt, case)
    for fn in (quant.conv_int8, quant.conv_int8_plain):
        for layout in (torch.contiguous_format, torch.channels_last):
            got = _port_conv(fn, x, wt, case, layout=layout)
            assert got.shape == want.shape, fn.__name__
            np.testing.assert_array_equal(got, want, err_msg="{} {}".format(
                fn.__name__, layout))


def test_conv_int8_zero_image_and_batch_independence():
    """An all-zero image gives zeros (the 1e-12 floor, no NaN), and an
    image's result does not depend on its batchmates (per-image
    scales): alone == in a batch with a 100x louder image."""
    x, wt = _operands("3x3_pad1", zero_image=0)
    got = _port_conv(quant.conv_int8, x, wt, "3x3_pad1")
    np.testing.assert_array_equal(got, _jax_conv(x, wt, "3x3_pad1"))
    assert (got[0] == 0).all() and np.isfinite(got).all()
    x, wt = _operands("3x3_pad1", seed=1)
    x[1] *= 100
    alone = _port_conv(quant.conv_int8, x[:1], wt, "3x3_pad1")
    paired = _port_conv(quant.conv_int8, x, wt, "3x3_pad1")
    np.testing.assert_array_equal(alone[0], paired[0])


def test_conv_int8_bfloat16_in_and_channels_last_layout():
    """A bfloat16 activation quantizes in float32, as odtpu's does, and
    the result, cast to bfloat16, keeps a channels-last input's layout."""
    x, wt = _operands("3x3_pad1", seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jquant.conv_int8(
        jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1),
                    jnp.bfloat16),
        jnp.asarray(wt.transpose(2, 3, 1, 0)), (1, 1), ((1, 1), (1, 1)),
        out_dtype=jnp.bfloat16).astype(jnp.float32)).transpose(0, 3, 1, 2)
    xcl = xb.contiguous(memory_format=torch.channels_last)
    got = quant.conv_int8(xcl, torch.from_numpy(wt), (1, 1), (1, 1),
                          (1, 1), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_weight_cache_follows_the_weight():
    """The cached weight operand is remade when the weight changes in
    place (an optimizer step) or is loaded over (load_state_dict)."""
    x, wt = _operands("3x3_pad1", seed=3)
    conv = Conv(16, 24, 3, padding=1, relu=False, dtype=torch.float32)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(wt))
    set_quant(conv, "int8")
    xt = torch.from_numpy(x)
    bias = conv.conv.bias.detach().numpy()[:, None, None]
    first = conv(xt).detach().numpy()
    np.testing.assert_array_equal(first,
                                  _jax_conv(x, wt, "3x3_pad1") + bias)
    assert conv(xt).detach().numpy().tobytes() == first.tobytes()
    with torch.no_grad():
        conv.conv.weight.mul_(-0.5)  # in place, as the optimizer steps
    want = _jax_conv(x, -0.5 * wt, "3x3_pad1") + bias
    np.testing.assert_array_equal(conv(xt).detach().numpy(), want)
    conv.load_state_dict({"conv.weight": torch.from_numpy(wt * 2),
                          "conv.bias": torch.zeros(24)})
    np.testing.assert_array_equal(conv(xt).detach().numpy(),
                                  _jax_conv(x, wt * 2, "3x3_pad1"))


@pytest.mark.parametrize("ssd_type,heads", [("SSD", "head."),
                                            ("RefineDet", "")])
def test_set_quant_modes_and_heads_opt_out(ssd_type, heads):
    """The loc/conf heads (SSD's MultiBoxHead, RefineDet's ARM and ODM
    heads: 4 sources, 2 convs each) opt out; every other conv follows
    set_quant."""
    cfg = tiny_cfg(default_cfg(), ssd_type)
    model, priors, _ = model_factory("eval", cfg, "cpu")
    assert set_quant(model, "int8") == ""
    names = [n for n, m in model.named_modules()
             if isinstance(m, Conv) and not m.quantizable]
    assert len(names) == (8 if ssd_type == "SSD" else 16), names
    assert all(n.startswith(heads) for n in names)
    assert all(m.quant == "int8" for m in model.modules()
               if isinstance(m, Conv))
    assert set_quant(model, "") == "int8"
    with pytest.raises(ValueError, match="quant mode"):
        set_quant(model, "int4")
    cfg.TPU.QUANT = "int4"
    with pytest.raises(ValueError, match="quant mode"):
        make_eval_step(model, priors, cfg)


def test_full_width_ssd300_int8_matches_odtpu_and_keeps_f32_rows():
    """Flagship weights, float32, batch 1: the int8 forward against
    odtpu's quantized("int8") apply; then the eval step's int8 rows
    against its float32 rows on the kind of image the weights know.
    The eval step restores the model's mode after each forward."""
    jcfg = jdefault_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel, _, _ = jmodel_factory("eval", jcfg)
    shapes = jax.eval_shape(lambda: init_model(jmodel, jcfg))["params"]
    params, loaded, skipped = jload_model_npz(shapes, FLAGSHIP)
    assert len(loaded) == 71 and not skipped
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model, priors, _ = model_factory("eval", cfg, "cpu")
    load_strict(model, load_odtpu_npz(FLAGSHIP, model))
    model.eval()

    x = ((_flagship_image(0).astype(np.float32) - MEANS)[..., ::-1]).copy()

    def japply(p, x):
        with quantized("int8"):
            return jmodel.apply({"params": p}, x, phase="train",
                                train=False)

    # eager, op by op, as odtpu/ops/quant.py is written: under jit XLA
    # turns s_x / 127 into a product by 1/127, which moves some scales by
    # an ulp and with them whole layers' integers
    want = japply(params, jnp.asarray(x))
    set_quant(model, "int8")
    with torch.no_grad():
        got = model(torch.from_numpy(x), phase="train")
    set_quant(model, "")
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())

    cfg_q = default_cfg()
    cfg_q.TPU.COMPUTE_DTYPE = "float32"
    cfg_q.TPU.QUANT = "int8"
    step32 = make_eval_step(model, priors, cfg)
    step8 = make_eval_step(model, priors, cfg_q)
    for seed in (0, 1):
        u8 = torch.from_numpy(_flagship_image(seed))
        r32 = step32(u8)["rows"][0].numpy()
        rq = step8(u8)["rows"][0].numpy()
        assert all(m.quant == "" for m in model.modules()
                   if isinstance(m, Conv))
        assert np.isfinite(rq).all() and (rq[:, 0] > 0).sum() > 0
        t32, tq = r32[np.argmax(r32[:, 0])], rq[np.argmax(rq[:, 0])]
        assert t32[5] == tq[5], (t32, tq)
        assert abs(t32[0] - tq[0]) < 0.05, (t32, tq)
        assert _iou(t32[1:5], tq[1:5]) >= 0.5, (t32, tq)


# (SSD_TYPE, base, batch norm) -> the largest gap allowed, and the mean
# gap, in quantization steps of each output (its largest value over 127)
NARROW = {("SSD", "vgg16", True): (1e-3, 1e-3),
          ("RefineDet", "vgg16", False): (1e-3, 1e-3),
          ("RefineDet", "vgg16", True): (1e-3, 1e-3),
          ("FPN", "vgg16", False): (1e-3, 1e-3),
          ("FPN", "vgg16", True): (1e-3, 1e-3),
          ("SSD", "drn_d_22", False): (1e-3, 1e-3)}


def _narrow_pair(case):
    """Both packages' models of one 64x64 case holding the same
    variables: the port's seeded init, its batch norms drawn at random
    (``torch_family_parity.random_norms``), carried to ``odtpu``'s tree
    by ``to_odtpu_params`` (whose structure must equal its init's)."""
    jcfg = tiny_cfg(jdefault_cfg(), *case)
    cfg = tiny_cfg(default_cfg(), *case)
    jmodel, _, _ = jmodel_factory("eval", jcfg)
    model, _, _ = model_factory("eval", cfg, "cpu")
    model.eval()
    variables = fp.odtpu_variables(model.state_dict())
    shapes = jax.eval_shape(lambda: init_model(jmodel, jcfg))
    assert jax.tree.structure(variables) == jax.tree.structure(dict(shapes))
    variables = fp.random_norms(variables)
    load_strict(model, from_odtpu_params(fp.flat_variables(variables),
                                         model))
    return jmodel, model, variables


@pytest.mark.parametrize("case", sorted(NARROW),
                         ids=lambda c: "_".join(map(str, c)))
def test_narrow_family_int8_matches_odtpu(case):
    """SSD, RefineDet and FPN over VGG16 with and without batch norm, and
    SSD over DRN-D-22 (their norms drawn at random) agree to float32
    rounding: every quantized conv sees odtpu's integers. This holds
    only because eval-mode batch norm computes flax's
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``: a norm that
    rounds otherwise in the last bit moves an activation across a half
    step now and then, its integer by one, and the next layers'
    quantization spreads that (``nn.BatchNorm2d``'s arithmetic gave 5.0
    to 6.2 steps at most)."""
    jmodel, model, variables = _narrow_pair(case)
    x = (fp.images((64, 64), seed=4).astype(np.float32)
         - MEANS)[..., ::-1].copy()
    with quantized("int8"):  # eager: see the full-width test
        want = jmodel.apply(variables, jnp.asarray(x), phase="train",
                            train=False)
    set_quant(model, "int8")
    with torch.no_grad():
        got = model(torch.from_numpy(x), phase="train")
    assert len(got) == len(want)
    largest, mean = NARROW[case]
    steps = []
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        gap = np.abs(g.numpy() - w)
        step = np.abs(w).max() / 127  # 0 for RefineDet's zero ARM loc
        assert gap.max() <= largest * step, (gap.max(), step)
        assert gap.mean() <= mean * step, (gap.mean(), step)
        if step > 0:
            steps.append((gap.max() / step, gap.mean() / step))
    # the reading PERF.md and ROADMAP.md quote (pytest -s)
    print("{}: largest gap {:.3g} steps, mean {:.3g}".format(
        case, max(m for m, _ in steps), max(a for _, a in steps)))


class _WatchInt8:
    """An ``EvalVOC`` stand-in that records, around each validation, the
    int8 GEMM calls made before it (by the train steps) and in it, the
    convs' modes after it, and whether the validation's rows equal those
    of an int8 eval step built by hand over a copy of the model."""

    def __init__(self, solver, cfg, images):
        self.solver, self.cfg, self.images = solver, cfg, images
        self.seen, self.last_timing = [], {}
        self.calls = quant.INT_MM_CALLS

    def validate(self, eval_fn, tb_writer=None):
        before = quant.INT_MM_CALLS
        out = self.solver.validate(eval_fn, tb_writer)
        during = quant.INT_MM_CALLS - before
        self.last_timing = self.solver.last_timing
        rows = eval_fn(self.images)["rows"]
        by_hand = copy.deepcopy(eval_fn.model).eval()
        want = make_eval_step(by_hand, eval_fn.priors, self.cfg)(
            self.images)["rows"]
        self.seen.append(dict(
            train_calls=before - self.calls, eval_calls=during,
            modes={m.quant for m in eval_fn.model.modules()
                   if isinstance(m, Conv)},
            rows_equal=torch.equal(rows, want)))
        self.calls = quant.INT_MM_CALLS
        return out


def test_fit_validates_in_int8_when_the_config_asks(tmp_path):
    """``TPU.QUANT = "int8"``: fit's train steps make no int8 GEMM call,
    its validation makes them, and the convs go back to the compute
    dtype after it, as odtpu's make_eval_step enters quantized() around
    its apply only."""
    make_voc(str(tmp_path / "voc"), n_images=2, seed=5)
    cfg = tiny_cfg(default_cfg(), "SSD")
    cfg.TPU.QUANT = "int8"
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    cfg.DATASET.TEST_SETS = (("2007", "test"),)
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    cfg.TRAIN.MAX_ITER = cfg.TRAIN.EVAL_ITER = cfg.TRAIN.SAVE_ITER = 2
    cfg.TRAIN.LOG_LOSS_ITER = 1
    train, solver = _tiny_voc_loaders(str(tmp_path / "voc"), cfg, tmp_path)
    images = next(iter(solver.loader))["images"]
    watch = _WatchInt8(solver, cfg, images)
    out = fit(cfg, train, watch, tmp_path / "run", device="cpu")
    assert out["step"] == 2 and len(watch.seen) == 1
    seen = watch.seen[0]
    assert seen["train_calls"] == 0 and seen["eval_calls"] > 0, seen
    assert seen["modes"] == {""} and seen["rows_equal"], seen
