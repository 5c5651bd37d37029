"""The port's ops (odtpu_torch.ops) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides as
numpy. Tolerances, and why:
- priors, top-k, every NMS mask: exact (same float32 arithmetic in the
  same order, or pure selection);
- decode: rtol 1e-6, because exp() in XLA and in torch may differ by an
  ulp or two;
- detect rows: atol 1e-6, the decode tolerance carried through.
"""

import importlib
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.ops import boxes as jboxes
from odtpu.ops import detect as jdetect
from odtpu.ops import topk as jtopk
from odtpu.ops.priors import PriorBoxSSD as JPriorBoxSSD
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch.ops import boxes, detect, nms, topk
from odtpu_torch.ops.cuda import nms_kernel
from odtpu_torch.ops.priors import PriorBoxSSD, prior_factory
from odtpu_torch.utils.config import default_cfg

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)

# odtpu.ops re-exports a function named ``nms`` over the module's name
jnms = importlib.import_module("odtpu.ops.nms")

GOLDENS = osp.join(osp.dirname(__file__), "goldens")
SSD300_DIMS = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """odtpu's Pallas NMS kernel in interpret mode, as
    tests/test_pallas_nms.py runs it on the CPU."""
    from odtpu.ops.pallas import nms_kernel as nk
    orig = nk.pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(nk.pl, "pallas_call", patched)
    return nk


def _sets(rng, n, k, ties=False):
    """n score-sorted candidate sets of k point-form boxes, clustered so
    that many pairs straddle the 0.45 IoU threshold."""
    centers = rng.uniform(0.2, 0.8, (n, 4, 2))
    pick = rng.randint(0, 4, (n, k))
    c = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.randn(n, k, 2) * 0.03
    wh = rng.uniform(0.05, 0.3, (n, k, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if ties:
        s = rng.choice([0.005, 0.2, 0.5, 0.9], (n, k)).astype(np.float32)
    else:
        s = rng.rand(n, k).astype(np.float32)
    s = -np.sort(-s, axis=1)
    return b, s


# ----------------------------------------------------------------- priors

def test_ssd300_priors_match_golden_and_odtpu():
    ours = PriorBoxSSD(default_cfg())(SSD300_DIMS)
    g = np.load(osp.join(GOLDENS, "reference_priors.npz"))
    assert ours.shape == (8732, 4)
    assert PriorBoxSSD(default_cfg()).num_priors == list(g["n300"])
    np.testing.assert_allclose(ours, g["p300"], rtol=0, atol=2e-7)
    np.testing.assert_array_equal(
        ours, JPriorBoxSSD(jdefault_cfg())(SSD300_DIMS))


def test_prior_factory_rejects_unknown_type():
    cfg = default_cfg()
    cfg.MODEL.PRIOR_TYPE = "Nope"
    with pytest.raises(KeyError):
        prior_factory(cfg)


# ------------------------------------------------------------ box math

def test_decode_point_form_center_size_match_odtpu(rng):
    priors = PriorBoxSSD(default_cfg())(SSD300_DIMS)
    loc = (rng.randn(2, 8732, 4) * 2).astype(np.float32)
    got = boxes.decode(_t(loc), _t(priors)[None], (0.1, 0.2)).numpy()
    want = np.asarray(jboxes.decode(jnp.asarray(loc),
                                    jnp.asarray(priors)[None], (0.1, 0.2)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        boxes.point_form(_t(priors)).numpy(),
        np.asarray(jboxes.point_form(jnp.asarray(priors))))
    np.testing.assert_array_equal(
        boxes.center_size(_t(want)).numpy(),
        np.asarray(jboxes.center_size(jnp.asarray(want))))


# ---------------------------------------------------------------- top-k

@pytest.mark.parametrize("values", [[0.0, 0.25, 0.5, 1.0], [0.5]])
def test_top_k_exact_ties_match_odtpu(values):
    x = np.random.RandomState(1).choice(values, (5, 8732)).astype(np.float32)
    v, i = topk.top_k_exact(_t(x), 200)
    jv, ji = jtopk.top_k_exact(jnp.asarray(x), 200)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def _tie_rows(n):
    """5 rows of n scores: three tie-heavy ({0, 0.25, 0.5, 1}), one all
    equal, one uniform."""
    rng = np.random.RandomState(n)
    x = rng.choice([0.0, 0.25, 0.5, 1.0], (5, n)).astype(np.float32)
    x[3] = 0.5
    x[4] = rng.rand(n)
    return x


@pytest.mark.parametrize("groups", [None, 4, 12, 17, 47])
@pytest.mark.parametrize("n", [8732, 24564, 4000])
def test_grouped_top_k_matches_odtpu(n, groups):
    """Padded n (8,732, 24,564) and n a multiple of G (4,000 at G = 8),
    values and indices bit-equal to odtpu's, ties included."""
    x = _tie_rows(n)
    v, i = topk.top_k_exact(_t(x), 200, groups=groups)
    jv, ji = jtopk.top_k_exact(jnp.asarray(x), 200, groups=groups)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("env", ["0", "8"])
@pytest.mark.parametrize("n", [8732, 4000])
def test_top_k_groups_from_the_environment_match_odtpu(monkeypatch, n, env):
    monkeypatch.setenv("ODTPU_TOPK_GROUPS", env)
    assert topk.num_groups(n, 200) == int(env)
    x = _tie_rows(n)
    v, i = topk.top_k_exact(_t(x), 200)
    jv, ji = jtopk.top_k_exact(jnp.asarray(x), 200)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# (n, G) at k = 200 on the port's shapes: SSD300 and its kin, RFBNet300,
# RefineDet320, SSD512-VOC, DRN_SSD, RFBNet512, the cross-class compaction
# over VOC's and COCO's classes, and survivors-first (flat)
TOPK_SHAPES = [(8732, 17), (11620, 22), (6375, 12), (24564, 47),
               (28158, 53), (32756, 62), (4000, 8), (16000, 30), (200, 1)]


@pytest.mark.parametrize("n,g", TOPK_SHAPES)
def test_top_k_groups_follow_odtpu_heuristic(monkeypatch, n, g):
    monkeypatch.delenv("ODTPU_TOPK_GROUPS", raising=False)
    want = max(1, round(n / max(2 * 200 + 128, jtopk._TARGET_GROUP)))
    assert topk.num_groups(n, 200) == want == g
    assert topk.num_groups(n, 200, groups=5) == 5


# ------------------------------------------------------------------ NMS

@pytest.mark.parametrize("n,k,ties", [(6, 50, False), (3, 37, False),
                                      (4, 64, True), (2, 200, False)])
def test_nms_masks_match_pallas_and_greedy(rng, pallas_interpret, n, k,
                                           ties):
    b, s = _sets(rng, n, k, ties)
    want = np.asarray(pallas_interpret.nms_mask_pallas(
        jnp.asarray(b), jnp.asarray(s), 0.45, 0.01))
    plain = nms_kernel.nms_mask_plain(_t(b), _t(s), 0.45, 0.01).numpy()
    greedy = nms._greedy_mask(_t(b), _t(s), 0.45, 0.01).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(greedy, want)
    for i in range(n):
        ref = np.asarray(jnms._greedy_mask(jnp.asarray(b[i]),
                                           jnp.asarray(s[i]), 0.45, 0.01))
        np.testing.assert_array_equal(greedy[i], ref)
    # the CPU wrapper takes the plain version
    np.testing.assert_array_equal(
        nms_kernel.nms_mask(_t(b), _t(s), 0.45, 0.01).numpy(), want)
    assert 0 < want.sum() < want.size  # both kills and survivors


def test_nms_mask_edge_sets(pallas_interpret):
    """Zero-area and identical boxes, an all-dead set, inf coordinates."""
    k = 8
    b = np.zeros((4, k, 4), np.float32)
    b[0] = [0.1, 0.1, 0.1, 0.4]  # zero-area copies: union 0, never kill
    b[1] = [0.2, 0.2, 0.6, 0.6]  # identical: the first kills the rest
    b[2] = b[1]
    b[3] = [0.2, 0.2, 0.6, 0.6]
    b[3, 2] = [-np.inf, 0.2, np.inf, 0.6]
    s = np.tile(np.linspace(0.9, 0.2, k, dtype=np.float32), (4, 1))
    s[2] = 0.0  # all dead on arrival
    want = np.asarray(pallas_interpret.nms_mask_pallas(
        jnp.asarray(b), jnp.asarray(s), 0.45, 0.01))
    got = nms_kernel.nms_mask_plain(_t(b), _t(s), 0.45, 0.01).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].all() and got[1].sum() == 1 and not got[2].any()


def test_per_class_nms_padded_small_batch(rng, pallas_interpret):
    """Zero-score dummy images appended to a B=1 batch change nothing, and
    the rows equal odtpu's per_class_nms_pallas (interpret mode)."""
    priors, loc, conf = _scene(rng, 1, 80, 6)
    decoded = boxes.decode(_t(loc), _t(priors)[None], (0.1, 0.2))
    conf_fg = _t(conf)[..., 1:]
    base = nms_kernel.per_class_nms(decoded, conf_fg, 0.01, 0.45, 20)
    want = np.asarray(pallas_interpret.per_class_nms_pallas(
        jnp.asarray(decoded.numpy()), jnp.asarray(conf_fg.numpy()), 0.01,
        0.45, 20))
    np.testing.assert_array_equal(base.numpy(), want)
    padded = nms_kernel.per_class_nms(
        torch.cat([decoded, torch.zeros(3, 80, 4)]),
        torch.cat([conf_fg, torch.zeros(3, 80, 5)]), 0.01, 0.45, 20)
    np.testing.assert_array_equal(padded[:1].numpy(), base.numpy())
    assert float(padded[1:].abs().sum()) == 0.0


def test_nms_rows_plain_matches_pallas_uncompacted_rows(rng,
                                                       pallas_interpret):
    """The rows entry's plain twin, fed the serving path's arguments (row
    slices of the per-set sort, the flat b*P + order gather over Cf
    classes), equals per_class_nms_pallas(compact_rows=False)."""
    priors, loc, conf = _scene(rng, 3, 150, 6)
    decoded = boxes.decode(_t(loc), _t(priors)[None], (0.1, 0.2))
    conf_fg = _t(conf)[..., 1:]
    top_scores, order = nms_kernel._top_order(conf_fg, 40)
    assert order.stride(0) == 150  # slices, as the kernel receives them
    rows = nms_kernel.nms_rows_plain(decoded, order, top_scores, 5, 0.45,
                                     0.01)
    want = np.asarray(pallas_interpret.per_class_nms_pallas(
        jnp.asarray(decoded.numpy()), jnp.asarray(conf_fg.numpy()), 0.01,
        0.45, 40, compact_rows=False))
    np.testing.assert_array_equal(rows.reshape(3, 5, 40, 5).numpy(), want)
    np.testing.assert_array_equal(
        nms_kernel.nms_rows(decoded, order, top_scores, 5, 0.45,
                            0.01).numpy(), rows.numpy())
    assert 0 < (want[..., 0] > 0).sum() < want[..., 0].size


@pytest.mark.parametrize("compact_rows", [False, True])
def test_per_class_nms_pads_short_sets_like_pallas(rng, pallas_interpret,
                                                   compact_rows):
    """P = 24 priors and top_k = 30: every set holds k = 24 candidates
    and 6 zero rows of padding."""
    priors, loc, conf = _scene(rng, 2, 24, 4)
    decoded = boxes.decode(_t(loc), _t(priors)[None], (0.1, 0.2))
    conf_fg = _t(conf)[..., 1:]
    got = nms_kernel.per_class_nms(decoded, conf_fg, 0.01, 0.45, 30,
                                   compact_rows=compact_rows).numpy()
    want = np.asarray(pallas_interpret.per_class_nms_pallas(
        jnp.asarray(decoded.numpy()), jnp.asarray(conf_fg.numpy()), 0.01,
        0.45, 30, compact_rows=compact_rows))
    assert got.shape == (2, 3, 30, 5)
    np.testing.assert_array_equal(got, want)
    assert not got[:, :, 24:].any()


def test_nms_rows_cuda_refuses_cpu_tensors_and_bad_shapes():
    decoded = torch.zeros(2, 10, 4)
    order = torch.zeros(6, 5, dtype=torch.int64)
    scores = torch.zeros(6, 5)
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.nms_rows_cuda(decoded, order, scores, 3, 0.45)
    with pytest.raises(ValueError, match="Cf = 2"):
        nms_kernel.nms_rows(decoded, order, scores, 2, 0.45)
    with pytest.raises(ValueError, match="want decoded"):
        nms_kernel.nms_rows_plain(decoded, order, scores[:, :4], 3, 0.45)


def test_nms_rows_match_odtpu(rng):
    b, s = _sets(rng, 1, 60)
    perm = rng.permutation(60)  # unsorted input: nms_rows sorts
    bx, sc = b[0][perm], s[0][perm]
    rows, count = nms.nms_rows(_t(bx), _t(sc), 0.45, 80, 0.01)
    jrows, jcount = jnms.nms_rows(jnp.asarray(bx), jnp.asarray(sc), 0.45,
                                  80, 0.01)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert int(count) == int(jcount)
    kb, ks, kc = nms.nms(_t(bx), _t(sc), 0.45, 80, 0.01)
    np.testing.assert_array_equal(kb.numpy(), np.asarray(jrows)[:, 1:])
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jrows)[:, 0])


def test_nms_mask_cuda_refuses_cpu_tensors():
    b = torch.zeros(2, 5, 4)
    s = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.nms_mask_cuda(b, s, 0.45)
    with pytest.raises(ValueError, match="want boxes"):
        nms_kernel.nms_mask(b, s[:1], 0.45)


# --------------------------------------------------------------- detect

def _scene(rng, B, P, C):
    priors = np.stack([rng.uniform(0.2, 0.8, P), rng.uniform(0.2, 0.8, P),
                       rng.uniform(0.1, 0.3, P), rng.uniform(0.1, 0.3, P)],
                      1).astype(np.float32)
    loc = (rng.randn(B, P, 4) * 0.1).astype(np.float32)
    logits = rng.randn(B, P, C).astype(np.float32)
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return priors, loc, conf.astype(np.float32)


@pytest.mark.parametrize("B,P,C,top_k", [(2, 300, 6, 50), (1, 80, 6, 20),
                                         (3, 500, 21, 200),
                                         (1, 8732, 3, 200)])
def test_detect_out_matches_odtpu(rng, B, P, C, top_k):
    priors, loc, conf = _scene(rng, B, P, C)
    args = ((0.1, 0.2), 0.01, 0.45, top_k)
    jargs = (jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors))
    want = np.asarray(jdetect.detect_out(*jargs, *args, impl="lax"))
    got = detect.detect_out(_t(loc), _t(conf), _t(priors), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    want_c = np.asarray(jdetect.detect_out_compact(*jargs, *args,
                                                   impl="lax"))
    got_c = detect.detect_out_compact(_t(loc), _t(conf), _t(priors),
                                      *args).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-6)

    # the reference path (odtpu's lax path on the port) gives the same
    decoded = boxes.decode(_t(loc), _t(priors)[None], (0.1, 0.2))
    ref = detect._finalize(detect._per_class_nms_reference(
        decoded, _t(conf)[..., 1:], 0.01, 0.45, top_k), top_k, False)
    np.testing.assert_array_equal(ref.numpy(), got)


def test_detect_out_matches_reference_golden():
    g = np.load(osp.join(GOLDENS, "reference_detect_out.npz"))
    det = detect.DetectOut(6, 0, 50, 0.01, 0.45, (0.1, 0.2))
    got = det(_t(g["loc"]), _t(g["conf"]), _t(g["priors"])).numpy()
    np.testing.assert_allclose(got, g["out"], rtol=1e-4, atol=1e-5)


def test_cross_class_topk_matches_odtpu(rng):
    priors, loc, conf = _scene(rng, 2, 300, 6)
    args = ((0.1, 0.2), 0.01, 0.45, 30, True)
    want = np.asarray(jdetect.detect_out(
        jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors), *args,
        impl="lax"))
    got = detect.detect_out(_t(loc), _t(conf), _t(priors), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
