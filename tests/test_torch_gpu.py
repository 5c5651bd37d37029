"""The CUDA greedy-NMS kernel's two entries against their plain twins,
the int8 conv (``torch._int_mm``) against its float64 oracle, the
serving path's launches (SSD300 and RefineDet320) and train steps
(SSD300, and SSD300 over DRN-D-22 with its batch norms) against the
CPU's, on a card.

These tests need a CUDA card and skip without one. This file imports no
JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

import chip_smoke
from odtpu_torch.infer import Detector, random_images, random_state_dict
from odtpu_torch.models import probe_layer_dims
from odtpu_torch.ops import detect, quant
from odtpu_torch.ops.boxes import decode
from odtpu_torch.ops.cuda import nms_kernel
from odtpu_torch.ops.priors import prior_factory
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
