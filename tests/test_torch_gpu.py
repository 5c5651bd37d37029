"""The two-level top-k against the flat sort, the CUDA greedy-NMS
kernel's two entries against their plain twins
(the registered op ``odtpu::nms_rows`` too), an exported artifact
against the live path, the int8 conv (``torch._int_mm``) against its float64 oracle, the
serving path's launches (SSD300 and RefineDet320) and train steps
(SSD300, and SSD300 over DRN-D-22 with its batch norms) against the
CPU's, the eval-mode batch norm's kernel and its backward entries, and
input-gradient saliency through them, on a card.

These tests need a CUDA card and skip without one. This file imports no
JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from odtpu_torch import train_debug
from odtpu_torch.infer import Detector, random_images, random_state_dict
from odtpu_torch.models import model_factory, probe_layer_dims
from odtpu_torch.ops import detect, quant, topk
from odtpu_torch.ops.boxes import decode
from odtpu_torch.ops.cuda import batch_norm, nms_kernel
from odtpu_torch.ops.priors import prior_factory
from odtpu_torch.utils.checkpoint import load_strict
from odtpu_torch.utils.config import default_cfg, load_cfg

pytestmark = pytest.mark.gpu


@pytest.fixture()
def priors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on one, run: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_gpu.py")
    cfg = default_cfg()
    return torch.from_numpy(
        prior_factory(cfg)(probe_layer_dims(cfg))).cuda()


@pytest.mark.parametrize("kind", chip_smoke.TOPK_KINDS)
@pytest.mark.parametrize("n", [8732, 32756])
def test_grouped_top_k_on_card_equals_flat_sort(priors, n, kind):
    """The two-level top-k at SSD300's and RFBNet512's shapes (640 sets
    of a batch of 32), ties included: the flat stable sort's values and
    indices on the card, and the CPU's."""
    x = chip_smoke.topk_scores(kind, 640, n)
    assert topk.num_groups(n, 200) >= 4
    assert chip_smoke.grouped_equals_flat(x)
    got = topk.top_k_exact(x, 200)
    want = topk.top_k_exact(x.cpu(), 200, groups=0)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_kernel_equals_plain_on_edge_cases(priors):
    g = torch.Generator().manual_seed(1)
    for label, boxes, scores in chip_smoke.edge_cases(g, priors):
        chip_smoke.check_kernel(boxes, scores, label)


def test_per_class_nms_on_card_equals_reference_path(priors):
    g = torch.Generator().manual_seed(2)
    P = priors.shape[0]
    loc = (torch.randn(4, P, 4, generator=g) * 0.5).cuda()
    conf = torch.softmax(torch.randn(4, P, 21, generator=g).cuda() * 2, -1)
    decoded = decode(loc, priors[None], (0.1, 0.2))
    before = nms_kernel.LAUNCHES
    got = nms_kernel.per_class_nms(decoded, conf[..., 1:], 0.01, 0.45, 200)
    assert nms_kernel.LAUNCHES == before + 1
    want = detect._per_class_nms_reference(decoded, conf[..., 1:], 0.01,
                                           0.45, 200)
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_what_it_cannot_take(priors):
    boxes = torch.rand(2, 8, 4, device="cuda")
    scores = torch.rand(2, 8, device="cuda")
    with pytest.raises(TypeError):
        nms_kernel.nms_mask_cuda(boxes.double(), scores.double(), 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        nms_kernel.nms_mask_cuda(boxes.transpose(0, 1).contiguous()
                                 .transpose(0, 1), scores, 0.45)
    with pytest.raises(ValueError, match="at most"):
        nms_kernel.nms_mask_cuda(torch.rand(1, 1025, 4, device="cuda"),
                                 torch.rand(1, 1025, device="cuda"), 0.45)


def test_rows_kernel_equals_twin_on_edge_cases(priors):
    g = torch.Generator().manual_seed(3)
    for label, boxes, scores in chip_smoke.edge_cases(g, priors):
        chip_smoke.check_rows(*chip_smoke.rows_case(g, boxes, scores), label)


def test_registered_op_equals_plain_on_edge_cases(priors):
    """``odtpu::nms_rows`` (what the serving path and an exported program
    call) launches the kernel once a call on CUDA tensors and gives the
    plain twin's rows, on the CPU copies too."""
    g = torch.Generator().manual_seed(4)
    for label, boxes, scores in chip_smoke.edge_cases(g, priors):
        case = chip_smoke.rows_case(g, boxes, scores)
        before = nms_kernel.ROWS_LAUNCHES
        got = torch.ops.odtpu.nms_rows(*case, chip_smoke.IOU,
                                       chip_smoke.CONF)
        torch.cuda.synchronize()
        assert nms_kernel.ROWS_LAUNCHES == before + 1, label
        want = nms_kernel.nms_rows_plain(*case, chip_smoke.IOU,
                                         chip_smoke.CONF)
        assert chip_smoke.same_bits(got, want), label
        cpu = [t.cpu() if torch.is_tensor(t) else t for t in case]
        assert chip_smoke.same_bits(got.cpu(), torch.ops.odtpu.nms_rows(
            *cpu, chip_smoke.IOU, chip_smoke.CONF)), label


def test_rows_wrapper_refuses_what_it_cannot_take(priors):
    decoded = torch.rand(2, 10, 4, device="cuda")
    order = torch.randint(0, 10, (6, 5), device="cuda")
    scores = torch.rand(6, 5, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.nms_rows_cuda(decoded.cpu(), order.cpu(), scores.cpu(), 3,
                                 0.45)
    with pytest.raises(ValueError, match="top_scores on"):
        nms_kernel.nms_rows_cuda(decoded.cpu(), order, scores, 3, 0.45)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows_cuda(decoded, order.int(), scores, 3, 0.45)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows_cuda(decoded.double(), order, scores, 3, 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        nms_kernel.nms_rows_cuda(decoded.transpose(0, 1).contiguous()
                                 .transpose(0, 1), order, scores, 3, 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        nms_kernel.nms_rows_cuda(decoded, order.t().contiguous().t(),
                                 scores, 3, 0.45)
    with pytest.raises(ValueError, match="Cf = 2"):
        nms_kernel.nms_rows_cuda(decoded, order, scores, 2, 0.45)
    with pytest.raises(ValueError, match="at most"):
        nms_kernel.nms_rows_cuda(
            torch.rand(1, 2000, 4, device="cuda"),
            torch.zeros(1, 1025, dtype=torch.int64, device="cuda"),
            torch.rand(1, 1025, device="cuda"), 1, 0.45)


def test_mask_kernel_writes_bool(priors):
    boxes = torch.rand(3, 40, 4, device="cuda").sort(-1)[0]
    scores = torch.rand(3, 40, device="cuda").sort(-1, descending=True)[0]
    alive = nms_kernel.nms_mask_cuda(boxes, scores, 0.45, 0.01)
    torch.cuda.synchronize()
    assert alive.dtype == torch.bool and alive.shape == (3, 40)
    assert int(alive.view(torch.uint8).max()) == 1  # 0 or 1, nothing else
    assert torch.equal(alive, nms_kernel.nms_mask_plain(boxes, scores, 0.45,
                                                        0.01))


def test_eval_step_takes_host_batches_and_launches_rows_once(priors):
    det = Detector(state_dict=random_state_dict(), device="cuda")
    before = nms_kernel.ROWS_LAUNCHES
    out = det(random_images(4, (300, 300), 0))  # numpy, as the loader gives
    torch.cuda.synchronize()
    assert nms_kernel.ROWS_LAUNCHES == before + 1
    assert out["rows"].is_cuda and out["rows"].shape == (4, 200, 6)
    assert torch.isfinite(out["rows"]).all()


def test_refinedet_served_on_card_equals_plain_detect(priors):
    """A family beyond SSD300: RefineDet320's two-step detect through one
    nms_rows launch a batch, rows equal to the plain path's."""
    cfg = load_cfg("refinedet320_vgg16_voc")
    det = Detector(cfg, random_state_dict(cfg), device="cuda")
    images = torch.from_numpy(random_images(4, (320, 320), 1)).cuda()
    before = nms_kernel.ROWS_LAUNCHES
    out = det(images)
    torch.cuda.synchronize()
    assert nms_kernel.ROWS_LAUNCHES == before + 1
    assert out["rows"].shape == (4, 200, 6)
    assert torch.isfinite(out["rows"]).all()
    want = chip_smoke.plain_rows(det.step, *det.step.forward(images))
    assert torch.equal(out["rows"], want)


# (B, Cin, H, W, O, kernel, stride, padding, dilation): conv1_1's K = 27,
# an O that is not a multiple of 8, a batch-1 request's 1x1 maps (M = 1),
# fc6's dilation 6, RFBNet's (3, 1) and a stride-2 extra
INT8_CASES = [(4, 3, 30, 30, 64, (3, 3), 1, (1, 1), 1),
              (2, 32, 12, 12, 12, (3, 3), 1, (1, 1), 1),
              (1, 256, 1, 1, 128, (1, 1), 1, (0, 0), 1),
              (1, 128, 3, 3, 256, (3, 3), 1, (0, 0), 1),
              (2, 64, 19, 19, 128, (3, 3), 1, (6, 6), 6),
              (2, 64, 10, 10, 32, (3, 1), 1, (1, 0), 1),
              (2, 64, 10, 10, 64, (3, 3), 2, (1, 1), 1)]


@pytest.mark.parametrize("case", INT8_CASES)
def test_conv_int8_on_card_equals_plain(priors, case):
    """The int8 conv through torch._int_mm on the card equals its float64
    oracle bit for bit, in bfloat16 from a channels-last input (as the
    served model gives it), and equals the same conv on the CPU."""
    b, cin, h, w, o, k, s, pad, d = case
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(b, cin, h, w, generator=g) * 3).to(torch.bfloat16)
    weight = torch.randn(o, cin, *k, generator=g)
    args = ((s, s), pad, (d, d), torch.bfloat16)
    xc = x.cuda().contiguous(memory_format=torch.channels_last)
    calls = quant.INT_MM_CALLS
    got = quant.conv_int8(xc, weight.cuda(), *args)
    assert quant.INT_MM_CALLS == calls + 1
    want = quant.conv_int8_plain(xc, weight.cuda(), *args)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(got.cpu(), quant.conv_int8(x, weight, *args))


def test_train_step_on_card_matches_cpu(priors):
    """One float32 step, TF32 off, B=2, against the CPU's float32 and
    float64 steps (chip_smoke's train_parity phase, which raises when a
    tensor gets no gradient in the float64 step, or a card update is off
    the CPU's by more than 1e-3 with cuDNN off or 5e-3 with cuDNN)."""
    result = chip_smoke.phase_train_parity()
    assert result["failing"] == [] and result["tensors"] == 71
    assert result["no_grad_f64"] == []
    assert result["card_no_cudnn"]["within_1e-3"] == 71
    assert result["card"]["num_pos"] == result["num_pos_cpu"] > 0


def test_batch_normed_train_step_on_card_matches_cpu(priors):
    """SSD300 over DRN-D-22, a norm after every conv: one float32 step
    (TF32 off, B=2) on the card and on the CPU from the same seeded
    weights, batch and augmentation parameters. The losses agree within
    rtol 1e-4, num_pos is equal, and every running statistic after the
    step lies within 1e-4 of the CPU's (``chip_smoke.stats_errors``: a
    variance in relative L2, a mean in units of its channel's standard
    deviation), all of them moved from init."""
    name = "ssd_drn22_voc"
    cfg = chip_smoke.train_cfg("float32", name)
    batch = chip_smoke.parity_batch(2, cfg=cfg)
    params = chip_smoke.draw_params(2, torch.Generator().manual_seed(5))
    weights = random_state_dict(cfg, seed=0)
    card = chip_smoke.family_parity_step("cuda", "float32", name, weights,
                                         batch, params)
    cpu = chip_smoke.family_parity_step("cpu", "float32", name, weights,
                                        batch, params)
    assert card["num_pos"] == cpu["num_pos"] > 0
    assert abs(card["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"])
    stats = chip_smoke.stats_errors(card["stats"], cpu["stats"])
    assert len(stats) == len(cpu["stats"]) > 0
    assert max(stats.values()) <= 1e-4, max(stats, key=stats.get)
    init = {k: v for k, v in weights.items() if k in cpu["stats"]}
    assert all(not torch.equal(cpu["stats"][k].float(), v)
               for k, v in init.items())


@pytest.mark.parametrize("name", ["ssd_vgg16_voc", "ssd_drn22_voc"])
def test_exported_artifact_on_card_equals_live_path(priors, tmp_path, name):
    """A batch-polymorphic bfloat16 artifact of seeded SSD300 (and over
    DRN-D-22, its norms the ``odtpu::bn_eval`` op), exported and loaded
    on the card: at B=1 and B=3 its rows equal the live ``Detector``'s on
    the same batch, one ``nms_rows`` launch a call."""
    from odtpu_torch import export
    from odtpu_torch.utils.checkpoint import to_odtpu_params
    cfg = load_cfg(name)
    weights = random_state_dict(cfg, seed=0)
    npz = tmp_path / "w.npz"
    np.savez(npz, **to_odtpu_params(weights))
    art = str(tmp_path / "model.zip")
    export.export_artifact(art, cfg, ckpt=str(npz), batch=0, device="cuda")
    call, meta = export.load_artifact(art, "cuda")
    det = Detector(cfg, weights, device="cuda")
    for b in (1, 3):
        images = torch.from_numpy(random_images(b, (300, 300), b)).cuda()
        before = nms_kernel.ROWS_LAUNCHES
        got = call(images)
        torch.cuda.synchronize()
        assert nms_kernel.ROWS_LAUNCHES == before + 1
        assert torch.equal(got, det(images)["rows"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_bn_eval_kernel_equals_plain(priors, dtype):
    """The eval-mode batch-norm kernel against its plain twin, bit for
    bit, channels-last and contiguous, with C and H*W multiples of 8 (one
    16-byte pack a thread) and not, and a row offset that breaks the
    pack's alignment; one launch a call, and a call that needs a gradient
    refused."""
    g = torch.Generator().manual_seed(9)
    wide = batch_norm.wide_dtype(dtype)
    for n, c, h, w in ((4, 64, 19, 19), (2, 24, 8, 8), (3, 3, 5, 7),
                       (1, 1024, 1, 1)):
        x = (torch.randn(n + 1, c, h, w, generator=g) * 3).to(dtype)
        params = [(torch.randn(c, generator=g) * s + o).to(wide).cuda()
                  for s, o in ((0.5, 0.0), (0.2, 1.0), (0.5, 0.0))]
        for xc in (x.cuda()[1:], x.cuda().contiguous(
                memory_format=torch.channels_last)[1:]):
            before = batch_norm.LAUNCHES
            got = batch_norm.bn_eval(xc, *params)
            assert batch_norm.LAUNCHES == before + 1
            want = batch_norm.bn_eval_plain(xc, *params)
            assert got.dtype == dtype and got.stride() == xc.stride()
            assert chip_smoke.same_bits(got, want), (n, c, h, w, dtype)
    leaf = params[1].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        batch_norm.bn_eval(xc, params[0], leaf, params[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_bn_eval_backward_kernel_equals_plain(priors, dtype):
    """The backward's dx entry against ``bn_eval_backward_plain`` bit for
    bit, a second launch bit-equal; channels-last and contiguous, packs
    and not (C or H*W not a multiple of 8, a row offset that breaks the
    alignment, more than 2048 channels); one launch a call."""
    g = torch.Generator().manual_seed(10)
    wide = batch_norm.wide_dtype(dtype)
    for n, c, h, w in ((4, 64, 19, 19), (2, 24, 8, 8), (3, 3, 5, 7),
                       (1, 1024, 1, 1), (3, 2056, 3, 3)):
        dy = torch.randn(n + 1, c, h, w, generator=g).to(dtype)
        mul = (torch.rand(c, generator=g) + 0.5).to(wide).cuda()
        for fmt in (torch.contiguous_format, torch.channels_last):
            for off in (0, 1):
                dyc = dy.cuda().contiguous(memory_format=fmt)[off:]
                before = batch_norm.DX_LAUNCHES
                dx = batch_norm.bn_eval_backward_dx_cuda(dyc, mul)
                assert batch_norm.DX_LAUNCHES == before + 1
                want = batch_norm.bn_eval_backward_plain(dyc, mul)
                case = (n, c, h, w, fmt, off)
                assert chip_smoke.same_bits(dx, want), case
                assert dx.stride() == dyc.stride(), case
                again = batch_norm.bn_eval_backward_dx_cuda(dyc, mul)
                assert chip_smoke.same_bits(dx, again), case


def test_saliency_on_card_runs_the_backward_kernel(priors):
    """``viz_grads`` of SSD300 over VGG16-BN on the card in float64: the
    backward's dx entry once for every norm upstream of each source
    (counted in the autograd graph), the gradients within 1e-9 relative
    L2 of the CPU's on the same weights and image (in float32 two conv
    implementations order max-pool windows of near-equal values
    otherwise and put the two apart; chip_smoke.saliency_parity prints
    it)."""
    cfg = load_cfg()
    cfg.MODEL.BATCH_NORM = True
    cfg.TPU.COMPUTE_DTYPE = "float64"
    # seeded weights, every norm drawn at random on the CPU
    det = Detector(cfg, random_state_dict(cfg, seed=0), device="cpu")
    images = random_images(1, cfg.MODEL.IMAGE_SIZE, seed=3)
    chip_smoke.random_norms(det, torch.from_numpy(images))
    weights = det.model.state_dict()
    image = (images.astype(np.float64) - np.float64([104, 117, 123]))
    image = np.ascontiguousarray(image[..., ::-1])
    grads = {}
    for device in ("cuda", "cpu"):
        model, _, _ = model_factory("eval", cfg, device)
        load_strict(model, weights)
        model.double()
        if device == "cuda":
            model = model.to(memory_format=torch.channels_last)
            per_source = chip_smoke.saliency_norms(
                model, torch.from_numpy(image).cuda())
            chip_smoke.reset_counts()
        grads[device] = train_debug.saliency(model, image, cfg,
                                             chip_smoke.recording_writer())
        if device == "cuda":
            assert len(per_source) == 6 and min(per_source) >= 1
            assert batch_norm.DX_LAUNCHES == sum(per_source)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert chip_smoke.rel_l2(torch.from_numpy(a),
                                 torch.from_numpy(b)) <= 1e-9
