"""Build the PyTorch/CUDA port, drive its main path on one CUDA card, check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
1. device: the card's name and count, and nvidia-smi's name and power
   limit (also printed alone, as nvidia-smi gives it). No card: exit 1.
2. build: nvcc builds every kernel of the path from ``odtpu_torch/csrc``
   with ``-Xptxas -v``; the line keeps the whole report and each entry's
   registers, spills and shared memory.
3. kernel: both entries of the greedy-NMS kernel, ``nms_mask`` and
   ``nms_rows``, against their plain torch twins on the main path's
   shapes (B = 32 images: 640 candidate sets of 200) and on edge cases;
   they must agree bit for bit. Each entry is timed with CUDA events:
   ``ms`` is 200 launches of the C entry from Python on a preallocated
   output, ``device_ms`` the same 200 launches replayed from a CUDA
   graph (the device alone), ``wrapper_ms`` 200 calls of its wrapper
   (``nms_rows`` also ``op_wrapper_ms``, 200 calls of the registered op
   ``odtpu::nms_rows`` that the serving path calls); beside its plain
   twin and its bound.
4. main path: seeded full-width SSD300-VGG16 serves uint8 300x300 batches
   of 32 through ``odtpu_torch.infer.Detector``, in bfloat16 (the serving
   default) and in float32 with TF32 off. ``nms_rows`` must launch once
   per batch and ``nms_mask`` never; the rows must be finite and must
   equal the plain detect path's on the same loc/conf; the float32
   forward must agree with the CPU's. Then the dense contract
   (``ops.detect.DetectOut`` on each batch's loc/conf) runs with the
   counts reset: ``nms_mask`` must launch once per call and ``nms_rows``
   never, and its rows must equal those of the same function on the CPU,
   where every op takes its plain version; the mask entry is held
   against its plain twin on the batch's candidates. In bfloat16 a
   ``detect_split`` line times each stage of the serving path's detect
   tail, on the device alone and as launched.
5. families: every other detector of the zoo at its published widths,
   with seeded weights (``infer.random_state_dict``): FPN300, FSSD300,
   RFBNet300, RFBNet512, SSD300 over DRN-D-22 and DRN-D-24, DRN_SSD,
   RefineDet320 (its two-step detect), SSD300-COCO (81 classes) and
   SSD512-VOC. Each serves bfloat16 uint8 batches of 32 through
   ``Detector`` (3 warm-up, 10 timed): ``nms_rows`` must launch once per
   batch and ``nms_mask`` never; the rows must be finite and equal the
   plain detect path's on the same outputs, and both kernel entries must
   equal their plain twins on the batch's candidates; the float32
   forward (TF32 off, batch 2) must agree with the CPU's on the same
   weights, their batch norms' statistics drawn at random, every output
   (loc within 1e-4 of its largest value, conf atol 1e-4). One line per configuration: P, images/s, ms/batch,
   ``forward_ms`` (and ``forward_nchw_ms``, the weights NCHW),
   ``detect_ms`` (and ``detect_device_ms``, the device alone), the
   convs' GFLOP an image and TFLOP/s, peak memory, and the ``nms_rows``
   entry's time on the batch's candidates beside its bound.
6. train: seeded full-width SSD300-VGG16 takes train steps on the card
   (bfloat16, batch 32, the photometric distortion on the device, LR
   1e-5, seeded uint8 300x300 images with one GT box each): 3 warm-up
   steps, then 20 timed by CUDA events; images/s, ms/step, the split by
   stage (augment, forward, loss = match and mine, backward, optimizer),
   peak memory, and every step's loss finite with num_pos > 0. The NMS
   kernel must not launch in a train step.
7. train_parity: one float32 step (TF32 off, batch 2) on the card and the
   same step on the CPU, with the same weights, batch and injected
   augmentation parameters, and on the CPU in float64.
   The card takes the step with cuDNN and again with cuDNN off. The
   batch gives every head and extra layer a gradient, which the float64
   step must show. Each tensor's card update must lie within a relative
   L2 error of 1e-3 of the CPU's with cuDNN off, and of 5e-3 with cuDNN;
   the counts within 1e-3, the ReLU sign flips between the forwards and
   the losses are printed.
8. family_train: every configuration of the families phase trains at
   full width from ``create_train_state``'s init, as ``train`` does for
   SSD300 (bf16, batch 32, 3 warm-up and 10 timed steps): ms/step,
   images/s, the split by stage, peak memory; every loss finite with
   num_pos > 0, every batch norm's running statistics finite and moved,
   no NMS launch. Each model is freed before the next.
9. family_train_parity: ``train_parity`` for RFBNet300 (batch norm) and
   RefineDet320 (its two-step loss, the ARM heads moved off their init
   so that the refined anchors, their clamp and the negative-anchor
   filter take part): one step on the card with and without cuDNN
   against the CPU's, in float64 and in float32. In float64 every
   update and running statistic must lie within the same limits; in
   float32 the losses, positives, ignored anchors and running statistics
   must, and the updates are printed beside the ReLU sign flips that
   put them off (see :func:`family_train_parity`).
10. fit: ``odtpu_torch.train.fit`` on a seeded VOC tree written to a
   temporary directory under ``build/`` (PPM images at the network's
   size, read by ``data.image.imread``, XML and ImageSets), through the
   pass-through transform: a first run from a
   ``--basenet`` npz saves and validates, a second auto-resumes from its
   checkpoint, saves and validates again. Each validation scores VOC mAP
   through the serving path, so ``nms_rows`` must launch once per eval
   batch. Then the same two runs of RFBNet300: each validation must
   leave its running statistics bit-equal, and a restore of the first
   run's checkpoint must give them back bit-equal.
11. data: the host pipeline on the card's host, with no OpenCV: a seeded
   VOC tree of 1536 PPM images (48 batches an epoch, so that no figure
   crosses an epoch's end, where the loader restarts its threads) at
   VOC's sizes (500x375, 375x500, 500x333 and odd ones), 1-4 boxes each,
   some difficult. The C++ sampler (``data.native.fused_sample_u8``) must
   equal its numpy twin bit for bit on the windows SSDAugmentation draws
   for 64 items and on the edge cases (a 1-pixel window, a window in the
   fill, a flip, exact 2x up and down); each is timed per item. Then the
   train loader's images/s (``dataset_factory("train")``) on the float
   host path (the default) and the uint8 device-photometric one, at 1 and
   8 workers after their first round, with the cores the process kept
   busy, beside ``os.cpu_count()`` and the affinity, and the ms an item
   of reading and of each mode's transform in one thread; and SSD300 bf16
   train steps at batch 32 fed by the loader (8 workers) in each mode,
   the metrics read a step late as ``fit`` reads them, 20 of them timed
   once the prefetch queue has drained: ms per step, split into waiting
   for a batch, the step's call and reading its metrics, the wait's
   share, the busy cores, and the same 20 batches again with no loader
   running; every loss finite with num_pos > 0, the sampler called on
   the uint8 path only.
12. cli: the two command lines at full width on such a tree (1024 + 64
   images): ``odtpu_torch.train``'s ``setup`` and ``run`` train SSD300
   (bf16, batch 32, the float host path, 8 workers) for 20 steps, inside
   one epoch, from a
   ``--basenet`` npz, save at 10 and 20, validate at 20, and trace steps
   11-20 with ``--profile_dir`` (the trace must exist; its kernel events
   give the card's busy share of the window); then ``odtpu_torch.eval``'s
   ``setup`` and ``run`` score the last checkpoint (``--ckpt``): its mAP
   and its detection files must equal the train run's last validation.
   ``nms_rows`` must launch once per eval batch in each, ``nms_mask``
   never.
13. coco: a seeded COCO tree (``instances_minival2014.json``, 64 PPM
   images at 640x480 and 480x640, the 80 category ids): the eval command
   line on ``ssd_vgg16_coco`` with the seeded served weights as an npz
   (``--model_npz``) gives mAP@0.5 and mAP@[.5:.95] in [0, 1] with one
   ``nms_rows`` launch per batch; ``EvalCOCO`` fed the ground truth as
   its rows scores 1.0 and 1.0.
14. int8: seeded SSD300 and every configuration of ``families`` served
   in bfloat16 and then through ``Detector(quant="int8")`` (s8 x s8 ->
   s32 convs by ``torch._int_mm``, the heads in bfloat16), uint8 batches
   of 32, 3 warm-up and 10 timed: images/s, ms/batch, ``forward_ms``
   (both modes in the same run), peak memory; ``nms_rows`` must launch
   once per batch and ``nms_mask`` never, ``torch._int_mm`` once per
   quantized conv a batch; the int8 rows (batch 2) must equal those of
   the same model with every quantized conv routed through
   ``ops.quant.conv_int8_plain``; printed, gating nothing (seeded
   weights): the share of bfloat16 rows that an int8 row keeps (same
   class, IoU >= 0.5). SSD300 adds an ``int8_split`` line: quantize,
   tap gather, ``_int_mm`` and rescale by CUDA events, per conv and
   summed, each ``_int_mm`` beside its bound (dense int8 operations or
   bytes, whichever takes longer).
15. serve: ``odtpu_torch.serve`` on 127.0.0.1 (a free port) in a thread,
   in bfloat16 and in int8: ``/healthz``, then 20 ``POST /detect`` of
   seeded PPM images at VOC's sizes (500x375, 375x500); every response
   carries detections and equals ``build_engine``'s ``infer`` called
   directly on the same bytes; one 404 and one 400. p50 and p90 of the
   request's wall time and of ``latency_ms``; one ``nms_rows`` launch
   per request.
16. export: seeded full-width SSD300 exported by ``odtpu_torch.export``
   (``torch.export`` through the registered op ``odtpu::nms_rows``) at
   batch 32 in bfloat16 and in int8 convs, and for any batch in
   bfloat16, under ``build/``; one fresh subprocess that imports only
   what ``load_artifact`` needs (no model, config or data module) loads
   and serves each, 3 warm-up and 10 timed calls: its rows equal the
   live ``Detector``'s on the same batch exactly (the polymorphic
   artifact's at B=1 and B=32), one ``nms_rows`` launch a call; ms per
   batch beside the live path's, export and load seconds, the
   artifact's bytes.
17. extras: bf16 SSD300 steps at batch 32 with ``LOSS.REPULSION_WEIGHT =
   0.5`` on :func:`parity_batch`'s several boxes an image
   (``loss_repul`` finite and > 0, the repelled priors counted); SSD300
   and RFBNet300 with ``TPU.REMAT`` off and on, 3 warm-up and 10 timed
   steps each: ms/step and peak memory; and one float32 step of each
   from the same state with and without remat (cuDNN deterministic):
   every update and running statistic within 1e-5 relative L2, the
   statistics moved once.
Each tree goes under ``build/`` and is removed after its phase. Then each
phase's seconds, the ``kernels`` line (the host sampler under ``host``,
the int8 GEMM under ``library``), and last ``{"ok": true, "device":
...}``, printed only when every phase passed.
"""

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from odtpu_torch import eval_step, export, train
from odtpu_torch import serve as http_serve
from odtpu_torch.data import augment, dataset_factory, native
from odtpu_torch.data.device_aug import draw_params
from odtpu_torch.data.image import imdecode, write_ppm
from odtpu_torch.data.loader import DetLoader, NetworkInput
from odtpu_torch.data.voc import VOC_CLASSES, VOCDetection
from odtpu_torch.eval import cli
from odtpu_torch.eval.evaluator import EvalVOC, eval_solver_factory
from odtpu_torch.infer import (Detector, power_limit, random_images,
                               random_state_dict)
from odtpu_torch.layers.losses import repulsion_loss
from odtpu_torch.models import create_model, probe_layer_dims
from odtpu_torch.models.common import BatchNorm2d, Conv
from odtpu_torch.ops import detect, quant
from odtpu_torch.ops.boxes import decode
from odtpu_torch.ops.cuda import batch_norm, build, nms_kernel
from odtpu_torch.ops.priors import prior_factory
from odtpu_torch.train import fit
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils.checkpoint import Checkpointer, to_odtpu_params
from odtpu_torch.utils.config import default_cfg, load_cfg

# H100 SXM peaks (NVIDIA H100 Tensor Core GPU data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and dense int8 tensor-core
# operations/s (3,958 TOPS is the sparse figure, half of it dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12
# float32 operations per (i, j) pair in the kernel's overlap test: four
# max/min, two subtracts, two clamps, the intersection product, the
# union's add and subtract, the threshold product and two compares
OPS_PER_PAIR = 14

BATCH = 32
IOU, CONF = 0.45, 0.01


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() on the device, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean milliseconds of fn() on the device alone: ``iters`` calls
    captured in a CUDA graph and replayed, so the host's cost of each
    launch does not count. ``fn`` launches on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / iters


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = power_limit()
    print(smi, flush=True)
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit({"phase": "device", **info, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return info, smi


def entry_of(symbol):
    """``nms_mask`` or ``nms_rows`` for a mangled kernel name."""
    return next((e for e in ("nms_mask", "nms_rows")
                 if e + "_kernel" in symbol), symbol)


def ptxas_report(log):
    """Registers, spills and shared memory of each kernel entry, from
    nvcc's ``-Xptxas -v`` output."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = entries.setdefault(entry_of(m.group(1)), {})
        elif cur is not None:
            for key, pattern in (
                    ("spill_stores", r"(\d+) bytes spill stores"),
                    ("spill_loads", r"(\d+) bytes spill loads"),
                    ("stack_frame", r"(\d+) bytes stack frame"),
                    ("registers", r"Used (\d+) registers"),
                    ("static_smem", r"(\d+) bytes smem")):
                m = re.search(pattern, line)
                if m:
                    cur[key] = int(m.group(1))
    return entries


# every CUDA source of the port, built by one nvcc each, all started
# together
SOURCES = ("nms_kernel", "batch_norm")


def phase_build():
    t0 = time.perf_counter()
    builds = {}
    threads = [threading.Thread(
        target=lambda n=name: builds.__setitem__(
            n, build.build(n, verbose=True)))
        for name in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in SOURCES:
        if name not in builds:
            raise AssertionError("the build of {} failed (see the "
                                 "traceback above)".format(name))
    for name in nms_kernel._C_ARGS:
        nms_kernel._kernel(name)  # load and bind it now
    batch_norm._kernel()
    report = {}
    for name in SOURCES:
        path, nvcc_s, log = builds[name]
        report[name] = {"library": path.name, "nvcc_seconds": nvcc_s,
                        "entries": ptxas_report(log),
                        "ptxas": [l.strip() for l in log.splitlines()
                                  if l.strip()]}
    emit({"phase": "build", "kernels": report,
          "seconds": time.perf_counter() - t0})
    entries = report["nms_kernel"]["entries"]
    missing = {"nms_mask", "nms_rows"} - {
        e for e, r in entries.items() if "spill_stores" in r}
    if missing or not report["batch_norm"]["entries"]:
        raise AssertionError("no ptxas report (with spills) for "
                             "{}".format(sorted(missing) or "batch_norm"))
    return {**entries, "batch_norm": report["batch_norm"]["entries"]}


def needed_pairs(boxes, scores, alive):
    """Pairs (i, j) a greedy NMS must test on these inputs: i kept, j
    later, j live (past the score threshold, not yet removed) at i's turn."""
    n, k = scores.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    w = (torch.minimum(x2[:, :, None], x2[:, None, :])
         - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0)
    h = (torch.minimum(y2[:, :, None], y2[:, None, :])
         - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0)
    inter = w * h
    union = area[:, :, None] + area[:, None, :] - inter
    idx = torch.arange(k, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    kills = (inter > IOU * union) & (union > 0) & later & alive[:, :, None]
    # first kept box that kills j (k when none does)
    first = torch.where(kills.any(1), kills.float().argmax(1),
                        torch.full_like(idx, k)[None].expand(n, k))
    live0 = scores > CONF
    need = alive[:, :, None] & later & live0[:, None, :] \
        & (first[:, None, :] >= idx[None, :, None])
    return int(need.sum())


def same_bits(a, b):
    """Equal bit for bit, in any dtype (NaN boxes included, -0.0 apart
    from 0.0)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    view = ints[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def check_kernel(boxes, scores, label):
    got = nms_kernel.nms_mask_cuda(boxes, scores, IOU, CONF)
    want = nms_kernel.nms_mask_plain(boxes, scores, IOU, CONF)
    torch.cuda.synchronize()
    if got.dtype != torch.bool or not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError("nms_mask kernel != plain on {}: {} of {} "
                             "entries differ".format(label, bad, got.numel()))
    return got


def check_rows(decoded, order, top_scores, cf, label):
    got = nms_kernel.nms_rows_cuda(decoded, order, top_scores, cf, IOU, CONF)
    want = nms_kernel.nms_rows_plain(decoded, order, top_scores, cf, IOU,
                                     CONF)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError("nms_rows kernel != plain on {}: {} of {} "
                             "values differ".format(
                                 label, int((got != want).sum()),
                                 want.numel()))
    return got


def rows_case(g, boxes, scores):
    """(decoded, order, top_scores, cf) that make nms_rows gather exactly
    ``boxes``: each set is an image of its own (cf = 1) whose K boxes sit
    at random places among 3 more."""
    n, k, _ = boxes.shape
    p = k + 3
    slots = torch.argsort(torch.rand(n, p, generator=g), 1)[:, :k]
    decoded = torch.rand(n, p, 4, generator=g).to(boxes.device)
    slots = slots.to(boxes.device)
    decoded.scatter_(1, slots[..., None].expand(n, k, 4), boxes)
    return decoded.contiguous(), slots.contiguous(), scores, 1


def scene(g, priors, batch):
    """Seeded decoded boxes and foreground scores of ``batch`` images."""
    dev = priors.device
    loc = (torch.randn(batch, priors.shape[0], 4, generator=g) * 0.5).to(dev)
    conf = torch.softmax(torch.randn(batch, priors.shape[0], 21,
                                     generator=g).to(dev) * 2, -1)
    return decode(loc, priors[None], (0.1, 0.2)), conf[..., 1:]


def edge_cases(g, priors):
    """(label, boxes, scores) sets that stress the kernel's edges."""
    dev = priors.device

    def sets(n, k, ties=False):
        c = torch.rand(n, 4, 2, generator=g) * 0.6 + 0.2
        pick = torch.randint(0, 4, (n, k), generator=g)
        ctr = torch.gather(c, 1, pick[..., None].expand(n, k, 2)) \
            + torch.randn(n, k, 2, generator=g) * 0.03
        wh = torch.rand(n, k, 2, generator=g) * 0.25 + 0.05
        b = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
        if ties:
            s = torch.tensor([0.005, 0.2, 0.5, 0.9])[
                torch.randint(0, 4, (n, k), generator=g)]
        else:
            s = torch.rand(n, k, generator=g)
        s = torch.sort(s, dim=1, descending=True, stable=True)[0]
        return b.to(dev).contiguous(), s.to(dev).contiguous()

    out = [("N=3,K=37", *sets(3, 37)), ("ties", *sets(64, 200, ties=True)),
           ("K=1", *sets(5, 1)), ("K=1024", *sets(2, 1024))]
    b, s = sets(8, 50)
    b[:, ::3, 2] = b[:, ::3, 0]  # zero-area boxes
    out.append(("zero-area", b, s))
    b, s = sets(8, 64)
    out.append(("all-dead", b, torch.zeros_like(s)))
    b, s = sets(4, 40)
    b[:, 5] = torch.tensor([float("-inf"), 0.2, float("inf"), 0.6])
    b[:, 7, 0] = float("nan")
    out.append(("inf-nan", b, s))
    # B = 1 through the real path's candidate selection: 20 sets
    out.append(("B=1", *nms_kernel.top_candidates(*scene(g, priors, 1),
                                                  200)))
    return out


def bound(nbytes, pairs):
    """The least time the card could take: bytes over HBM rate, pair
    tests over the f32 rate, whichever is longer."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * pairs * OPS_PER_PAIR / PEAK_F32_FLOP_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def phase_kernel(priors, ptxas):
    g = torch.Generator().manual_seed(0)
    dev = priors.device
    decoded, conf_fg = scene(g, priors, BATCH)
    cf = conf_fg.shape[-1]
    # the serving path's inputs: row slices of the per-set sort
    top_scores, order = nms_kernel._top_order(conf_fg, 200)
    boxes, scores = nms_kernel.top_candidates(decoded, conf_fg, 200)
    n, k = scores.shape
    main = "N={},K={}".format(n, k)
    alive = check_kernel(boxes, scores, main)
    rows = check_rows(decoded, order, top_scores, cf, main)
    if not torch.equal(rows[..., 0] > 0, alive):
        raise AssertionError("nms_rows' kept rows != nms_mask's alive mask")
    cases = {main: int(alive.sum())}
    for label, b, s in edge_cases(g, priors):
        cases[label] = int(check_kernel(b, s, label).sum())
        check_rows(*rows_case(g, b, s), label)
    one, one_fg = scene(g, priors, 1)
    one_scores, one_order = nms_kernel._top_order(one_fg, 200)
    check_rows(one, one_order, one_scores, cf, "B=1 rows")

    # each C entry on preallocated outputs; then through its wrapper,
    # which checks and allocates
    mask_fn = nms_kernel._kernel("odtpu_nms_mask")
    rows_fn = nms_kernel._kernel("odtpu_nms_rows")
    out_mask = torch.zeros((n, k), dtype=torch.bool, device=dev)
    out_rows = torch.zeros((n, k, 5), dtype=torch.float32, device=dev)

    def raw_mask():
        err = mask_fn(boxes.data_ptr(), scores.data_ptr(),
                      out_mask.data_ptr(), n, k, IOU, CONF,
                      torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("nms_mask launch failed: CUDA error "
                               "{}".format(err))

    def raw_rows():
        err = rows_fn(decoded.data_ptr(), order.data_ptr(),
                      top_scores.data_ptr(), out_rows.data_ptr(), n, k, cf,
                      decoded.shape[1], order.stride(0), top_scores.stride(0),
                      IOU, CONF, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("nms_rows launch failed: CUDA error "
                               "{}".format(err))

    for _ in range(3):
        raw_mask()
        raw_rows()
        nms_kernel.nms_mask_plain(boxes, scores, IOU, CONF)
    # launched from Python one after another (``ms``, as first defined),
    # then the same launches replayed from a CUDA graph: the device's
    # time alone
    mask_ms = cuda_ms(raw_mask, 200)
    rows_ms = cuda_ms(raw_rows, 200)
    mask_device_ms = graph_ms(raw_mask, 200)
    rows_device_ms = graph_ms(raw_rows, 200)
    if not torch.equal(out_mask, alive) or not same_bits(out_rows, rows):
        raise AssertionError("timed kernel launches changed the output")
    mask_wrapper_ms = cuda_ms(
        lambda: nms_kernel.nms_mask_cuda(boxes, scores, IOU, CONF), 200)
    rows_wrapper_ms = cuda_ms(lambda: nms_kernel.nms_rows_cuda(
        decoded, order, top_scores, cf, IOU, CONF), 200)
    # the same calls through the registered op odtpu::nms_rows, which
    # the serving path and an exported program call
    rows_op_ms = cuda_ms(lambda: torch.ops.odtpu.nms_rows(
        decoded, order, top_scores, cf, IOU, CONF), 200)
    mask_plain_ms = cuda_ms(
        lambda: nms_kernel.nms_mask_plain(boxes, scores, IOU, CONF), 20)
    rows_plain_ms = cuda_ms(lambda: nms_kernel.nms_rows_plain(
        decoded, order, top_scores, cf, IOU, CONF), 20)

    pairs = needed_pairs(boxes, scores, alive)
    nk = n * k
    common = {"route": "cuda", "source": "odtpu_torch/csrc/nms_kernel.cu",
              "replaces": "odtpu/ops/pallas/nms_kernel.py:61",
              "exact": True, "max_abs_err": 0.0, "library_ms": None,
              "needed_pairs": pairs, "shape": [n, k]}
    mask = {"name": "nms_mask", **common, "ms": mask_ms,
            "device_ms": mask_device_ms, "wrapper_ms": mask_wrapper_ms,
            "plain_ms": mask_plain_ms,
            # boxes and scores read, the bool mask written
            **bound(nk * (16 + 4 + 1), pairs),
            "ptxas": ptxas.get("nms_mask", {})}
    rows_result = {
        "name": "nms_rows", **common, "ms": rows_ms,
        "device_ms": rows_device_ms, "wrapper_ms": rows_wrapper_ms,
        "op_wrapper_ms": rows_op_ms, "plain_ms": rows_plain_ms,
        # the gathered boxes, the order and the scores read, rows written
        **bound(nk * (16 + 8 + 4 + 20), pairs),
        "ptxas": ptxas.get("nms_rows", {})}
    emit({"phase": "kernel", "cases_kept": cases,
          "entries": [mask, rows_result]})
    return mask, rows_result


def plain_rows(step, *outputs):
    """The eval step's rows from the plain detect path: odtpu's lax path
    (ops.nms.nms_rows per set), no kernel; RefineDet's outputs through
    its two-step decode."""
    decoded, conf = step.decode(*outputs)
    dense = detect._finalize(detect._per_class_nms_reference(
        decoded, conf[..., 1:], step.conf_thresh, step.nms_thresh,
        step.top_k), step.top_k, False)
    return detect._compact(dense, step.rows_cap)


def reset_counts():
    nms_kernel.LAUNCHES = nms_kernel.MASK_LAUNCHES = 0
    nms_kernel.ROWS_LAUNCHES = 0
    batch_norm.LAUNCHES = 0


def norm_calls(det, images):
    """Eval-mode batch norms one forward of ``det`` runs on ``images``."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append(m))
             for m in det.model.modules() if isinstance(m, BatchNorm2d)]
    try:
        det.step.forward(images)
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


def counts():
    """Kernel launches of each entry since the last reset_counts()."""
    if nms_kernel.LAUNCHES != nms_kernel.MASK_LAUNCHES \
            + nms_kernel.ROWS_LAUNCHES:
        raise AssertionError("launch counts disagree")
    return {"nms_mask": nms_kernel.MASK_LAUNCHES,
            "nms_rows": nms_kernel.ROWS_LAUNCHES}


def detect_split(step, loc, conf, iters=20):
    """ms of each stage of the detect tail on the stages' real inputs, by
    CUDA events over ``iters`` calls: the device's time alone (the calls
    replayed from a CUDA graph) and as launched from Python."""
    top_k = step.top_k
    conf_fg = conf[..., 1:]
    cf = conf_fg.shape[-1]
    decoded = decode(loc, step.priors[None], step.variances)
    top_scores, order = nms_kernel._top_order(conf_fg, top_k)
    rows = nms_kernel.nms_rows_cuda(decoded, order, top_scores, cf,
                                    step.nms_thresh, step.conf_thresh)
    out_fg = rows.reshape(loc.shape[0], cf, top_k, 5)
    dense = detect._finalize(out_fg, top_k, False)
    compact = detect._compact(dense, step.rows_cap)
    stages = {
        "decode": lambda: decode(loc, step.priors[None], step.variances),
        "top_k_per_set": lambda: nms_kernel._top_order(conf_fg, top_k),
        "nms_rows": lambda: nms_kernel.nms_rows_cuda(
            decoded, order, top_scores, cf, step.nms_thresh,
            step.conf_thresh),
        "finalize": lambda: detect._finalize(out_fg, top_k, False),
        "compact": lambda: detect._compact(dense, step.rows_cap),
        "dropped_audit": lambda: eval_step.dropped(dense, compact),
    }
    device, launched = {}, {}
    with torch.inference_mode():
        for name, fn in stages.items():
            device[name] = graph_ms(fn, iters)
            launched[name] = cuda_ms(fn, iters)
    return device, launched


def dense_contract(step, loc, conf, label, calls=5):
    """Drive the dense contract: ``DetectOut``, the reference's detect
    layer, on one batch's loc/conf, ``calls`` times with the counts reset.
    It must launch ``nms_mask`` once per call, and its rows must equal the
    same function's on the CPU, where every op takes its plain version."""
    detect_out = detect.DetectOut(conf.shape[-1], 0, step.top_k,
                                  step.conf_thresh, step.nms_thresh,
                                  step.variances)
    reset_counts()
    for _ in range(calls):
        dense = detect_out(loc, conf, step.priors)
    torch.cuda.synchronize()
    launches = counts()
    if launches != {"nms_mask": calls, "nms_rows": 0}:
        raise AssertionError("{} DetectOut calls made NMS kernel launches "
                             "{}; want one nms_mask launch per call".format(
                                 calls, launches))
    ms = cuda_ms(lambda: detect_out(loc, conf, step.priors), 5)
    decoded = decode(loc, step.priors[None], step.variances)
    want = detect._finalize(nms_kernel.per_class_nms(
        decoded.cpu(), conf[..., 1:].cpu(), step.conf_thresh,
        step.nms_thresh, step.top_k), step.top_k, False)
    if not same_bits(dense.cpu(), want):
        raise AssertionError("DetectOut on the card != on the CPU: {} of {} "
                             "values differ".format(
                                 int((dense.cpu() != want).sum()),
                                 want.numel()))
    # the mask entry against its plain twin on this batch's candidates
    check_kernel(*nms_kernel.top_candidates(decoded, conf[..., 1:],
                                            step.top_k),
                 "{} batch candidates".format(label))
    return {"calls": calls, "launches": launches, "ms": ms,
            "kept": int((dense[..., 0] > 0).sum()), "equal_cpu": True}


def serve(label, cfg, warmup, batches, quant_mode=None):
    """Serve seeded uint8 batches of ``BATCH`` images of ``cfg`` through
    ``Detector(quant=quant_mode)`` on the card, the counts reset just
    before the timed batches and read just after: one ``nms_rows`` launch
    per batch and no ``nms_mask``, rows of the right shape, finite, some
    kept; ``torch._int_mm`` calls counted beside them. Returns (detector,
    weights, images, the serving numbers)."""
    weights = random_state_dict(cfg, seed=0)
    det = Detector(cfg, weights, device="cuda", quant=quant_mode)
    images = torch.from_numpy(
        random_images(BATCH, cfg.MODEL.IMAGE_SIZE, 0)).cuda()
    for _ in range(warmup):
        det(images)
    norms = norm_calls(det, images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    int_mm = quant.INT_MM_CALLS
    t0 = time.perf_counter()
    for _ in range(batches):
        out = det(images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    bn_launches = batch_norm.LAUNCHES
    int_mm = quant.INT_MM_CALLS - int_mm
    peak = torch.cuda.max_memory_allocated()
    if launches != {"nms_mask": 0, "nms_rows": batches}:
        raise AssertionError("{}: {} batches made NMS kernel launches {}; "
                             "want one nms_rows launch per batch".format(
                                 label, batches, launches))
    if bn_launches != batches * norms:
        raise AssertionError("{}: {} batches of {} eval-mode batch norms "
                             "made {} bn_eval launches".format(
                                 label, batches, norms, bn_launches))
    rows, dropped = out["rows"], out["dropped"]
    if rows.shape != (BATCH, det.step.rows_cap, 6) \
            or dropped.shape != (BATCH,):
        raise AssertionError("{}: rows {} dropped {}".format(
            label, tuple(rows.shape), tuple(dropped.shape)))
    if not torch.isfinite(rows).all():
        raise AssertionError("{}: non-finite rows".format(label))
    kept = int((rows[..., 0] > 0).sum())
    if kept == 0:
        raise AssertionError("{}: no detections at all".format(label))
    return det, weights, images, {
        "batch": BATCH, "batches": batches,
        "images_per_s": BATCH * batches / seconds,
        "ms_per_batch": 1e3 * seconds / batches,
        "max_memory_allocated": peak, "launches": launches,
        "bn_eval_launches": bn_launches, "int_mm_calls": int_mm,
        "kept_rows": kept,
        "dropped": int(dropped.sum())}


def phase_main_path(dtype, warmup=3, batches=20):
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    det, weights, images, served = serve(dtype, cfg, warmup, batches)
    step = det.step

    # where a batch's time goes: the forward and the detect tail alone
    forward_ms = cuda_ms(lambda: step.forward(images), 5)
    loc, conf = step.forward(images)
    detect_ms = cuda_ms(lambda: step.detect(loc, conf), 5)
    got = step.detect(loc, conf)
    want = plain_rows(step, loc, conf)
    if not torch.equal(got["rows"], want):
        raise AssertionError("kernel rows != plain detect rows: {} of {} "
                             "differ".format(int((got["rows"] != want).sum()),
                                             want.numel()))

    dense = dense_contract(step, loc, conf, dtype)

    result = {"phase": "main_path", "dtype": dtype, **served,
              "forward_ms": forward_ms, "detect_ms": detect_ms,
              "nms_launches": sum(served["launches"].values()),
              "dense": dense, "rows_equal_plain": True}
    if dtype == "bfloat16":
        device, launched = detect_split(step, loc, conf)
        emit({"phase": "detect_split", "dtype": dtype, "batch": BATCH,
              "device_ms": device, "device_sum_ms": sum(device.values()),
              "launched_ms": launched,
              "launched_sum_ms": sum(launched.values()),
              "detect_device_ms": graph_ms(
                  lambda: step.detect(loc, conf), 20),
              "detect_ms": detect_ms, "nvidia_smi": power_limit()})

    if dtype == "float32":
        result["f32_vs_cpu"] = forward_gap("ssd_vgg16_voc", weights,
                                           images[:2])
    emit(result)
    return result


# every configuration of the zoo but the main path's SSD300-VGG16 VOC
FAMILIES = ("fpn_vgg16_voc", "fssd_vgg16_voc", "rfbnet300_vgg16_voc",
            "rfbnet512_vgg16_voc", "ssd_drn22_voc", "ssd_drn24_voc",
            "drnssd_drn22_voc", "refinedet320_vgg16_voc", "ssd_vgg16_coco",
            "ssd_vgg16_voc_image512")


def random_norms(det, images, seed=0):
    """Draws, in place, every batch norm of ``det``'s model at random:
    scale in 0.5..1.5, bias in +-0.5, and running statistics in units of
    the layer's activation scale s on ``images`` (s^2 the mean of its
    channels' variances): each channel's mean within +-0.5 s of its own,
    the variance s^2 times 0.5..1.5. So a norm is not the identity it is
    at init (1, 0, 0, 1), and it normalises the layer as a trained one
    does. Drawn without regard to the activations (the seeded weights'
    first conv is divided by up to 512), the norms' offsets swamp them
    and grow DRN's logits to ~300, where float32 rounding alone, on the
    CPU too, moves softmaxed conf past 1e-4; drawn per channel, a quiet
    channel's rounding noise is scaled up to a loud one's."""
    g = torch.Generator().manual_seed(seed)

    def draw(bn, args):
        x = args[0].double()
        var = x.var((0, 2, 3), unbiased=False)
        s2 = var.mean()

        def u():
            return torch.rand(var.numel(), generator=g, dtype=torch.float64)

        bn.running_mean.copy_(x.mean((0, 2, 3)) + (u() - 0.5) * s2.sqrt())
        bn.running_var.copy_(s2 * (0.5 + u()))
        bn.weight.data.copy_(0.5 + u())
        bn.bias.data.copy_(u() - 0.5)

    hooks = [m.register_forward_pre_hook(draw) for m in det.model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    det.step.forward(images)
    for h in hooks:
        h.remove()


def forward_gap(name, weights, images):
    """The float32 forward (TF32 off) of configuration ``name`` on the
    card against the CPU's, same images, on ``weights`` with the batch
    norms drawn by :func:`random_norms`: per output, the largest
    difference, the output's largest value, and the card's and the
    CPU's largest difference from the CPU's float64 forward; raises past
    the SSD300 tolerance (loc-like outputs within 1e-4 of their largest
    value, confs atol 1e-4: the sums run in another order, in float32 on
    both with TF32 off)."""
    cfg = load_cfg(name)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg64 = load_cfg(name)
    cfg64.TPU.COMPUTE_DTYPE = "float64"
    with torch.inference_mode():
        cpu_det = Detector(cfg, weights, device="cpu")
        random_norms(cpu_det, images.cpu())
        weights = cpu_det.model.state_dict()
        card = Detector(cfg, weights, device="cuda").step.forward(images)
        cpu = cpu_det.step.forward(images.cpu())
        det64 = Detector(cfg64, weights, device="cpu")
        det64.model.double()
        ref = det64.step.forward(images.cpu())
    gaps = []
    for i, (c, w, r) in enumerate(zip(card, cpu, ref)):
        c, r = c.cpu(), r.double()
        err = (c - w).abs().max().item()
        scale = w.abs().max().item()
        is_conf = i % 2 == 1  # (loc, conf) or RefineDet's two pairs
        limit = 1e-4 if is_conf else 1e-4 * scale
        gaps.append({"err": err, "scale": scale, "limit": limit,
                     "card_vs_f64": (c - r).abs().max().item(),
                     "cpu_vs_f64": (w - r).abs().max().item()})
        if not err <= limit:
            raise AssertionError("card forward != CPU forward, output {}: "
                                 "err {} > {}".format(i, err, limit))
    return gaps


def conv_flops(cfg):
    """Forward FLOPs of one image through ``cfg``'s convs, counted from a
    forward on the ``meta`` device: 2 x kh x kw x Cin x Cout x Hout x Wout
    per conv (get_flops.py's multiply-adds, doubled; biases, norms and
    upsampling left out)."""
    total = 0

    def count(module, inputs, output):
        nonlocal total
        w = module.conv.weight
        total += 2 * output[0].numel() * w[0].numel()

    with torch.device("meta"):
        model, _ = create_model(cfg)
        model.eval()
        hooks = [m.register_forward_hook(count) for m in model.modules()
                 if isinstance(m, Conv)]
        model(torch.empty(1, *cfg.MODEL.IMAGE_SIZE, 3))
    for h in hooks:
        h.remove()
    return total


def serve_family(name, warmup=3, batches=10):
    """One configuration served as the main path serves SSD300: bf16
    batches of 32 through ``Detector``, checked and timed."""
    cfg = load_cfg(name)
    det, weights, images, served = serve(name, cfg, warmup, batches)
    step = det.step
    forward_ms = cuda_ms(lambda: step.forward(images), 5)
    # the same forward with the weights NCHW-contiguous, which the
    # detector does not serve: what channels_last gains or costs where
    # batch norm, concatenation and upsampling meet it
    det.model.to(memory_format=torch.contiguous_format)
    step.forward(images)
    forward_nchw_ms = cuda_ms(lambda: step.forward(images), 5)
    det.model.to(memory_format=torch.channels_last)
    outputs = step.forward(images)
    detect_ms = cuda_ms(lambda: step.detect(*outputs), 5)
    got = step.detect(*outputs)
    want = plain_rows(step, *outputs)
    if not torch.equal(got["rows"], want):
        raise AssertionError("{}: kernel rows != plain detect rows: {} of "
                             "{} differ".format(
                                 name, int((got["rows"] != want).sum()),
                                 want.numel()))
    # both kernel entries against their plain twins on this batch's
    # candidates: N = B * (C - 1) sets over P priors
    decoded, conf = step.decode(*outputs)
    conf_fg = conf[..., 1:]
    top_scores, order = nms_kernel._top_order(conf_fg, step.top_k)
    label = "{} batch candidates".format(name)
    cf = conf_fg.shape[-1]
    check_rows(decoded, order, top_scores, cf, label)
    boxes, scores = nms_kernel.top_candidates(decoded, conf_fg, step.top_k)
    alive = check_kernel(boxes, scores, label)
    # the rows entry on this shape through its wrapper, launched from
    # Python (the kernel phase's wrapper_ms) and on the device alone,
    # beside its bound on these inputs
    n, k = scores.shape

    def rows_call():
        return nms_kernel.nms_rows_cuda(decoded, order, top_scores, cf,
                                        step.nms_thresh, step.conf_thresh)

    kernel = {"shape": [n, k], "wrapper_ms": cuda_ms(rows_call, 20),
              "device_ms": graph_ms(rows_call, 20),
              **bound(n * k * (16 + 8 + 4 + 20),
                      needed_pairs(boxes, scores, alive))}
    with torch.inference_mode():
        detect_device_ms = graph_ms(lambda: step.detect(*outputs), 20)
    norm = check_bn_eval(det, images, name)
    dispatch = bn_dispatch(det, images, name) if norm else None

    gaps = forward_gap(name, weights, images[:2])
    flops = conv_flops(cfg)
    result = {"phase": "families", "cfg": name, "dtype": "bfloat16",
              "family": cfg.MODEL.SSD_TYPE, "base": cfg.MODEL.BASE,
              "image_size": list(cfg.MODEL.IMAGE_SIZE),
              "classes": cfg.MODEL.NUM_CLASSES, "P": step.priors.shape[0],
              "sets": BATCH * cf, "warmup": warmup, **served,
              "forward_ms": forward_ms, "forward_nchw_ms": forward_nchw_ms,
              "detect_ms": detect_ms, "detect_device_ms": detect_device_ms,
              "gflop_per_image": flops / 1e9,
              "forward_tflop_per_s": flops * BATCH / forward_ms / 1e9,
              "max_abs_loc": float(outputs[-2].abs().max()),
              "rows_equal_plain": True, "nms_rows": kernel,
              "bn_eval": norm, "bn_dispatch": dispatch, "f32_vs_cpu": gaps}
    emit(result)
    return result


def check_bn_eval(det, images, label, iters=20):
    """The eval-mode batch-norm kernel against its plain twin on the
    inputs one forward of ``det`` gives each of its norms (the first of
    each shape, with that norm's statistics), bit for bit; the largest
    timed through its wrapper, on the device alone, beside its plain
    twin, ``F.batch_norm`` (cuDNN's, in its own rounding) and its bound.
    None for a model without batch norm."""
    seen = {}

    def grab(bn, args):
        key = (tuple(args[0].shape), args[0].dtype)
        if key not in seen:
            seen[key] = (bn, args[0].detach().clone())

    hooks = [m.register_forward_pre_hook(grab) for m in det.model.modules()
             if isinstance(m, BatchNorm2d)]
    try:
        det.step.forward(images)
    finally:
        for h in hooks:
            h.remove()
    if not seen:
        return None
    cases = []
    for bn, x in seen.values():
        wide = batch_norm.wide_dtype(x.dtype)
        mul = torch.rsqrt(bn.running_var.to(wide) + bn.eps) \
            * bn.weight.detach().to(wide)
        args = (x, bn.running_mean.to(wide), mul,
                bn.bias.detach().to(wide))
        got = batch_norm.bn_eval_cuda(*args)
        want = batch_norm.bn_eval_plain(*args)
        if not same_bits(got, want):
            raise AssertionError("{}: bn_eval kernel != plain on {} {}: {} "
                                 "of {} values differ".format(
                                     label, tuple(x.shape), x.dtype,
                                     int((got != want).sum()), x.numel()))
        cases.append((bn, args))
    bn, args = max(cases, key=lambda c: c[1][0].numel())
    x = args[0]
    with torch.no_grad():  # cuDNN's eval-mode norm on the same input
        library_ms = cuda_ms(lambda: F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            False, 0.0, bn.eps), iters)
    nbytes = 2 * x.numel() * x.element_size() + 3 * 4 * x.shape[1]
    ops_ms = 1e3 * 3 * x.numel() / PEAK_F32_FLOP_PER_S
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"shapes": len(cases), "exact": True, "max_abs_err": 0.0,
            "largest": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "channels_last": bool(x.is_contiguous(
                memory_format=torch.channels_last)),
            "ms": cuda_ms(lambda: batch_norm.bn_eval_cuda(*args), iters),
            "device_ms": graph_ms(lambda: batch_norm.bn_eval_cuda(*args),
                                  iters),
            "plain_ms": cuda_ms(lambda: batch_norm.bn_eval_plain(*args),
                                iters),
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "bytes": nbytes}


def bn_dispatch(det, images, label, rounds=2, warmup=3, batches=10):
    """Host ms per batch of ``det`` with its eval-mode norms as served
    (the kernel's wrapper called directly, each norm's parameters kept
    per version), with every norm through the registered op
    ``odtpu::bn_eval`` instead, and with each norm's parameters made anew
    at every call: what the direct call and the kept parameters save, in
    turns (served, op, uncached, uncached, op, served, ...). The rows
    must not change."""
    served, kept = batch_norm.bn_eval, BatchNorm2d.eval_params

    def uncached(bn, dtype):
        bn.__dict__.pop("_eval_cache", None)
        return kept(bn, dtype)

    variants = {"served": (served, kept),
                "op": (torch.ops.odtpu.bn_eval, kept),
                "uncached": (served, uncached)}
    order = list(variants)
    want = det(images)["rows"]
    ms = {v: [] for v in variants}
    try:
        for _ in range(rounds // 2):
            for v in order + order[::-1]:
                batch_norm.bn_eval, BatchNorm2d.eval_params = variants[v]
                got, _ = live_ms(det, images, warmup, batches)
                ms[v].append(got)
                if not torch.equal(det(images)["rows"], want):
                    raise AssertionError("{}: the norms {} changed the "
                                         "rows".format(label, v))
    finally:
        batch_norm.bn_eval, BatchNorm2d.eval_params = served, kept
    return {"order": " ".join(order + order[::-1]), "rounds": rounds // 2,
            "batches": batches, "ms_per_batch": ms}


def phase_families():
    t0 = time.perf_counter()
    results = [serve_family(name) for name in FAMILIES]
    emit({"phase": "families_done", "configurations": len(results),
          "seconds": time.perf_counter() - t0, "nvidia_smi": power_limit()})
    return results


def train_batch(batch, seed=0, device="cuda", size=(300, 300)):
    """bench.py ``_train_throughput``'s inputs: seeded uint8 BGR images
    (300x300 unless ``size``), one GT box [0.2, 0.2, 0.7, 0.7] with label
    3 each, padded to 60 with label -1."""
    images = torch.from_numpy(random_images(batch, size, seed))
    boxes = torch.zeros(batch, 60, 4)
    boxes[:, 0] = torch.tensor([0.2, 0.2, 0.7, 0.7])
    labels = torch.full((batch, 60), -1, dtype=torch.int32)
    labels[:, 0] = 3
    return images.to(device), boxes.to(device), labels.to(device)


def train_cfg(dtype, name="ssd_vgg16_voc"):
    cfg = load_cfg(name)
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    return cfg


STAGES = ("augment", "forward", "loss", "backward", "optimizer")


def stage_split(step, state, images, boxes, labels, iters):
    """ms of each stage of a train step, by CUDA events recorded between
    the stages of ``iters`` steps (the device's timeline, launch gaps
    included), averaged."""
    marks = []
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        x = step.augment(images, state.step)
        ev[1].record()
        outputs = step.forward(state, x)
        ev[2].record()
        metrics = step.loss(outputs, boxes, labels, state.step)
        ev[3].record()
        step.backward(state, metrics)
        ev[4].record()
        step.update(state)
        ev[5].record()
        marks.append(ev)
    torch.cuda.synchronize()
    return {name: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / iters
            for i, name in enumerate(STAGES)}


def phase_train(warmup=3, steps=20, split_iters=10):
    cfg = train_cfg("bfloat16")
    state, priors = create_train_state(cfg, "cuda", seed=0)
    step = make_train_step(priors, cfg)
    images, boxes, labels = train_batch(BATCH)
    for _ in range(warmup):
        step(state, images, boxes, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = [step(state, images, boxes, labels) for _ in range(steps)]
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != {"nms_mask": 0, "nms_rows": 0}:
        raise AssertionError("train steps launched the NMS kernel: "
                             "{}".format(launches))
    ms = start.elapsed_time(end) / steps
    losses = [float(m["loss"]) for m in metrics]
    num_pos = [int(m["num_pos"]) for m in metrics]
    if not all(math.isfinite(v) for v in losses) or min(num_pos) <= 0:
        raise AssertionError("train losses {} num_pos {}".format(losses,
                                                                 num_pos))
    split = stage_split(step, state, images, boxes, labels, split_iters)
    result = {"phase": "train", "dtype": "bfloat16", "batch": BATCH,
              "warmup_steps": warmup, "steps": steps,
              "images_per_s": BATCH * 1e3 / ms, "ms_per_step": ms,
              "host_ms_per_step": 1e3 * host_s / steps,
              "split_ms": split, "split_sum_ms": sum(split.values()),
              "split_steps": split_iters, "max_memory_allocated": peak,
              "losses": losses, "num_pos": num_pos, "all_finite": True,
              "launches": launches, "step": state.step,
              "nvidia_smi": power_limit()}
    emit(result)
    return result


def rel_l2(got, want):
    """||got - want|| / ||want||; 0 when they are equal, inf when only
    ``want`` is 0."""
    diff = float((got - want).norm())
    return 0.0 if diff == 0.0 else diff / float(want.norm())


def prior_scales(cfg):
    """Each prior map's scale (MIN_SIZES over the image side) and side:
    SSD300's are (0.1, 38), (0.2, 19), (0.37, 10), (0.54, 5), (0.71, 3),
    (0.88, 1)."""
    size = float(cfg.MODEL.IMAGE_SIZE[0])
    return [(m / size, h) for m, (h, _) in zip(cfg.MODEL.MIN_SIZES,
                                              probe_layer_dims(cfg))]


def parity_batch(batch, seed=1, cfg=None):
    """Images like photographs (smooth seeded colour fields with mild
    noise, uint8 BGR) of ``cfg``'s size (SSD300's by default) and, in
    each, one GT box for each prior scale, centred on a cell of that
    scale's map, so that every head and every extra layer gets a
    gradient."""
    cfg = cfg or default_cfg()
    size = cfg.MODEL.IMAGE_SIZE[0]
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    images = np.empty((batch, size, size, 3), np.float64)
    boxes = torch.zeros(batch, 60, 4)
    labels = torch.full((batch, 60), -1, dtype=torch.int32)
    for b in range(batch):
        for c in range(3):
            a = rng.uniform(-1, 1, 5)
            images[b, :, :, c] = (128 + 60 * np.sin(3 * a[0] * xx + 2 * a[1]
                                                    * yy + a[2])
                                  + 40 * np.cos(4 * a[3] * xx * yy + a[4]))
        images[b] += rng.normal(0, 2, (size, size, 3))
        for i, (side, n) in enumerate(prior_scales(cfg)):
            cx = ((b * 7 + i * 3) % n + 0.5) / n
            cy = (((b + 1) * 5 + i) % n + 0.5) / n
            stretch = 1.0 + 0.15 * (b - 0.5)
            w, h = side * stretch, side / stretch
            boxes[b, i] = torch.tensor([cx - w / 2, cy - h / 2, cx + w / 2,
                                        cy + h / 2]).clamp(0.0, 1.0)
            labels[b, i] = (3 * i + b) % 20
    images = torch.from_numpy(np.clip(images, 0, 255).astype(np.uint8))
    return images, boxes, labels


def relu_masks(model):
    """{conv name: bool mask of its ReLU's positive outputs}, filled by
    each forward of ``model``."""
    masks = {}
    for name, mod in model.named_modules():
        if getattr(mod, "relu", False) is True:
            mod.register_forward_hook(
                lambda m, i, o, name=name: masks.__setitem__(
                    name, (o > 0).cpu()))
    return masks


def relu_flips(a, b):
    """Outputs of the Conv ReLUs whose sign differs between two forwards'
    masks (:func:`relu_masks`)."""
    return sum(int((a[k] != m).sum()) for k, m in b.items())


def parity_step(device, dtype, weights, batch, params):
    """One train step from ``weights``: (loss, num_pos, ReLU masks, names
    of the tensors without a gradient, {name: update in float64})."""
    images, boxes, labels = batch
    cfg = train_cfg(dtype)
    cfg.TRAIN.OPTIMIZER.LR = 1e-3  # the default
    state, priors = create_train_state(cfg, device, seed=0)
    state.model.load_state_dict(weights)
    masks = relu_masks(state.model)
    step = make_train_step(priors, cfg)
    before = {k: v.detach().clone()
              for k, v in state.model.state_dict().items()}
    m = step(state, images, boxes, labels, aug_params=params)
    after = state.model.state_dict()
    no_grad = [k for k, p in state.model.named_parameters()
               if p.grad is None or not bool(p.grad.any())]
    return (float(m["loss"]), int(m["num_pos"]), masks, no_grad,
            {k: (after[k] - before[k]).double().cpu() for k in before})


def phase_train_parity(batch=2, tol=1e-3, cudnn_limit=5e-3):
    """One float32 step (TF32 off) on the card and on the CPU from the same
    weights (:func:`random_state_dict`), batch and augmentation
    parameters; beside them the same step on the CPU in float64 (the
    distortion, the model and the loss), the exact answer.

    The card takes the step twice: as the train path runs it, with
    cuDNN's convs, and with cuDNN off (PyTorch's own CUDA convs, GEMMs).
    Every tensor must get a gradient in the float64 step (an update of
    weight decay alone would match trivially). Each card update is held
    to the CPU's, tensor by tensor, in relative L2: within ``tol`` with
    cuDNN off, within ``cudnn_limit`` with cuDNN, whose float32 conv
    algorithms round more (PERF.md: the card 1.7e-3 from float64 with
    cuDNN, 5.4e-4 without, the CPU 7.4e-4). ``cudnn_limit`` was set from
    the readings of the runs before this batch (4.86e-3 on uint8 noise).
    The ReLU outputs whose sign differs between two float32 forwards are
    counted: each such flip moves the early convs' updates by ~1e-4 to
    ~1e-3.
    """
    data = parity_batch(batch)
    params = draw_params(batch, torch.Generator().manual_seed(5))
    weights = random_state_dict(seed=0)
    runs = {"cpu_f64": parity_step("cpu", "float64", weights, data, params),
            "cpu": parity_step("cpu", "float32", weights, data, params)}
    runs["card"] = parity_step("cuda", "float32", weights, data, params)
    with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        runs["card_no_cudnn"] = parity_step("cuda", "float32", weights,
                                            data, params)
    cpu, exact = runs["cpu"], runs["cpu_f64"]

    result = {"phase": "train_parity", "dtype": "float32", "tf32": False,
              "batch": batch, "images": "smooth fields + noise std 2",
              "gt_per_image": len(prior_scales(default_cfg())),
              "tensors": len(exact[4]),
              "no_grad_f64": exact[3], "loss_cpu": cpu[0],
              "loss_cpu_f64": exact[0], "num_pos_cpu": cpu[1],
              "max_cpu_vs_f64": max(rel_l2(cpu[4][k], v)
                                    for k, v in exact[4].items()),
              "relu_flips_cpu_vs_f64": relu_flips(cpu[2], exact[2]), "failing": []}
    for name, limit in (("card", cudnn_limit), ("card_no_cudnn", tol)):
        run = runs[name]
        vs_cpu = {k: rel_l2(run[4][k], v) for k, v in cpu[4].items()}
        worst = max(vs_cpu, key=vs_cpu.get)
        result[name] = {
            "limit": limit, "loss": run[0], "num_pos": run[1],
            "max_vs_cpu": vs_cpu[worst], "worst": worst,
            "within_1e-3": sum(v <= tol for v in vs_cpu.values()),
            "over_1e-3": sorted(k for k, v in vs_cpu.items() if v > tol),
            "max_vs_f64": max(rel_l2(run[4][k], v)
                              for k, v in exact[4].items()),
            "relu_flips_vs_cpu": relu_flips(run[2], cpu[2]),
            "relu_flips_vs_f64": relu_flips(run[2], exact[2]),
            "rel_l2_vs_cpu": vs_cpu}
        result["failing"] += ["{} {}".format(name, k)
                              for k, v in vs_cpu.items() if not v <= limit]
        if run[1] != cpu[1] or not math.isclose(run[0], cpu[0],
                                                rel_tol=1e-4):
            result["failing"].append("{} loss {} num_pos {}".format(
                name, run[0], run[1]))
    emit(result)
    if exact[3] or len(exact[4]) != 71:
        raise AssertionError("tensors without a gradient in the float64 "
                             "step: {}".format(exact[3]))
    if result["failing"]:
        raise AssertionError("card step off the CPU's: {}".format(
            result["failing"]))
    return result


def running_stats(model):
    """{name: clone} of ``model``'s batch norms' running statistics."""
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def train_family(name, warmup=3, steps=10, split_iters=5):
    """Seeded full-width ``name`` (``create_train_state``'s init) takes
    bf16 train steps of ``BATCH`` images on the card, as ``phase_train``
    does for SSD300, its gradient clipped at a global norm of 10: every
    loss finite with num_pos > 0, no NMS launch, every running statistic
    finite and moved from its init."""
    cfg = train_cfg("bfloat16", name)
    # the clip of cfgs/tests/*_ft.yml: from init at pixel scale, FPN300's
    # unclipped steps at LR 1e-5 diverge to NaN within four steps, as
    # odtpu's would
    cfg.TRAIN.OPTIMIZER.CLIP_GRAD_NORM = 10.0
    state, priors = create_train_state(cfg, "cuda", seed=0)
    init = running_stats(state.model)
    step = make_train_step(priors, cfg)
    images, boxes, labels = train_batch(BATCH, size=cfg.MODEL.IMAGE_SIZE)
    for _ in range(warmup):
        step(state, images, boxes, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = [step(state, images, boxes, labels) for _ in range(steps)]
    end.record()
    end.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    ms = start.elapsed_time(end) / steps
    losses = [float(m["loss"]) for m in metrics]
    num_pos = [int(m["num_pos"]) for m in metrics]
    stats = running_stats(state.model)
    moved = sum(not torch.equal(v, init[k]) for k, v in stats.items())
    finite = all(bool(torch.isfinite(v).all()) for v in stats.values())
    split = stage_split(step, state, images, boxes, labels, split_iters)
    result = {"phase": "family_train", "cfg": name, "dtype": "bfloat16",
              "family": cfg.MODEL.SSD_TYPE, "base": cfg.MODEL.BASE,
              "batch_norm": bool(stats), "batch": BATCH,
              "image_size": list(cfg.MODEL.IMAGE_SIZE),
              "P": priors.shape[0], "clip_grad_norm": 10.0,
              "warmup_steps": warmup, "steps": steps,
              "ms_per_step": ms, "images_per_s": BATCH * 1e3 / ms,
              "split_ms": split, "split_sum_ms": sum(split.values()),
              "split_steps": split_iters, "max_memory_allocated": peak,
              "losses": losses, "num_pos": num_pos, "launches": launches,
              "running_stats": len(stats), "stats_moved": moved,
              "stats_finite": finite}
    emit(result)
    if launches != {"nms_mask": 0, "nms_rows": 0}:
        raise AssertionError("{}: train steps launched the NMS kernel: "
                             "{}".format(name, launches))
    if not all(math.isfinite(v) for v in losses) or min(num_pos) <= 0:
        raise AssertionError("{}: train losses {} num_pos {}".format(
            name, losses, num_pos))
    if not finite or moved != len(stats):
        raise AssertionError("{}: {} of {} running statistics moved, "
                             "finite {}".format(name, moved, len(stats),
                                                finite))
    return result


def phase_family_train():
    results = []
    for name in FAMILIES:
        results.append(train_family(name))
        # free the model and its optimizer before the next one
        gc.collect()
        torch.cuda.empty_cache()
    return results


def perturbed_arm(weights, seed=0):
    """RefineDet's seeded weights with its ARM heads moved off their init,
    so that a step exercises the refined anchors, their log-scale clamp
    and the negative-anchor filter: random loc kernels (the init's are
    zero), each level's first anchor's log-scales biased to +-25 (past
    the clamp of 20.7), and the background logit biased by +4, which
    puts part of the anchors past P(bg) = 0.99."""
    g = torch.Generator().manual_seed(seed)
    out = dict(weights)
    for key, value in weights.items():
        if key.startswith("arm_loc_") and key.endswith("weight"):
            out[key] = torch.randn(value.shape, generator=g) * 0.01
        elif key.startswith("arm_loc_") and key.endswith("bias"):
            out[key] = value.clone()
            out[key][2:4] = torch.tensor([25.0, -25.0])
        elif key.startswith("arm_conf_") and key.endswith("bias"):
            out[key] = value.clone()
            out[key][0::2] += 4.0
    return out


def arm_ignored(model, step, images, params):
    """Anchors RefineDet's ARM holds to be background (P > 0.99) on the
    step's augmented ``images``."""
    with torch.no_grad():
        x = step.augment(images, 0, params)
        arm_conf = model(x, phase="train")[1]
        return int((torch.softmax(arm_conf, -1)[..., 0] > 0.99).sum())


def family_parity_step(device, dtype, name, weights, batch, params):
    """One train step of ``name`` from ``weights`` (SGD, LR 1e-3), as a
    dict: loss, num_pos, ignored anchors (RefineDet, else None), the
    names without a gradient, {name: momentum after the step}, {name:
    running statistic}, both in float64 on the CPU, and the Conv ReLUs'
    masks (:func:`relu_masks`)."""
    images, boxes, labels = (t.to(device) for t in batch)
    cfg = train_cfg(dtype, name)
    cfg.TRAIN.OPTIMIZER.LR = 1e-3  # the default
    state, priors = create_train_state(cfg, device, seed=0)
    state.model.load_state_dict(weights)
    if dtype == "float64":
        state.model.double()
        priors = priors.double()
    step = make_train_step(priors, cfg)
    ignored = (arm_ignored(state.model, step, images, params)
               if step.refinedet else None)
    masks = relu_masks(state.model)
    m = step(state, images, boxes, labels, aug_params=params)
    opt = state.optimizer.state
    return {
        "loss": float(m["loss"]), "num_pos": int(m["num_pos"]),
        "ignored": ignored, "masks": masks,
        "no_grad": [k for k, p in state.model.named_parameters()
                    if p.grad is None or not bool(p.grad.any())],
        "momentum": {k: opt[p]["momentum_buffer"].double().cpu()
                     for k, p in state.model.named_parameters()},
        "stats": {k: v.double().cpu()
                  for k, v in running_stats(state.model).items()}}


def momentum_errors(got, want):
    """{name: error} of each momentum in ``got`` against ``want``: the
    relative L2 error, taken against 1e-3 of the layer's largest update
    where the tensor's own is smaller (an RFB branch's last norm feeds a
    1x1 conv and a train-mode norm, which removes its channels' means:
    that norm's bias has no gradient in exact arithmetic, and its update
    is weight decay and rounding noise, ~1e-8)."""
    layer = {}
    for k, v in want.items():
        name = k.rsplit(".", 2)[0]
        layer[name] = max(layer.get(name, 0.0), float(v.norm()))
    return {k: float((got[k] - v).norm()) / max(
        float(v.norm()), 1e-3 * layer[k.rsplit(".", 2)[0]], 1e-30)
        for k, v in want.items()}


def stats_errors(got, want):
    """{name: error} of running statistics: a variance in relative L2, a
    mean in units of its channel's running standard deviation (a mean
    near 0 has no relative precision)."""
    out = {}
    for k, v in want.items():
        if k.endswith("running_var"):
            out[k] = rel_l2(got[k], v)
            mean = k[:-len("var")] + "mean"
            out[mean] = float((got[mean] - want[mean]).abs().max()
                              / (v + 1e-5).sqrt().min())
    return out


def global_error(got, want):
    """Relative L2 error of all the momenta at once."""
    return rel_l2(torch.cat([got[k].flatten() for k in want]),
                  torch.cat([v.flatten() for v in want.values()]))


def family_train_parity(name, batch=2, tol=1e-3, cudnn_limit=5e-3):
    """:func:`phase_train_parity` for a batch-normed family or RefineDet,
    from the same seeded weights (``random_state_dict``; RefineDet's ARM
    heads moved by :func:`perturbed_arm`), batch (:func:`parity_batch` at
    the family's size) and augmentation parameters on every side: one
    step on the card with cuDNN and with cuDNN off (TF32 off), and on the
    CPU, each in float64 and in float32.

    The float64 steps are held: each tensor's update (its momentum after
    the step, the gradient plus the weight decay, before the learning
    rate rounds it to the weight's ulp; :func:`momentum_errors`) and each
    running statistic (:func:`stats_errors`) within ``tol`` of the CPU's
    with cuDNN off and ``cudnn_limit`` with cuDNN; the losses within rtol
    1e-4 and the positives and ignored anchors equal. Every tensor must
    get a gradient on the CPU.

    The float32 steps are held the same way in their losses, positives,
    ignored anchors and running statistics. Their updates are printed
    against the CPU's float32 and float64 steps, not held: in these nets
    a float32 forward flips the sign of a few dozen ReLU inputs that lie
    within rounding of 0, and each flip sends the whole gradient at its
    position the other way, so two float32 steps differ per tensor by
    more than ``tol`` (the flips against the CPU's float64 step are
    printed for every float32 step)."""
    cfg = train_cfg("float32", name)
    data = parity_batch(batch, cfg=cfg)
    params = draw_params(batch, torch.Generator().manual_seed(5))
    weights = random_state_dict(cfg, seed=0)
    if cfg.MODEL.SSD_TYPE == "RefineDet":
        weights = perturbed_arm(weights)
    runs = {}
    for dtype, tag in (("float64", "_f64"), ("float32", "")):
        runs["cpu" + tag] = family_parity_step("cpu", dtype, name, weights,
                                               data, params)
        runs["card" + tag] = family_parity_step("cuda", dtype, name,
                                                weights, data, params)
        with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            runs["card_no_cudnn" + tag] = family_parity_step(
                "cuda", dtype, name, weights, data, params)
    exact = runs["cpu_f64"]
    result = {"phase": "family_train_parity", "cfg": name, "tf32": False,
              "batch": batch, "tensors": len(exact["momentum"]),
              "running_stats": len(exact["stats"]),
              "no_grad_cpu": runs["cpu"]["no_grad"],
              "no_grad_cpu_f64": exact["no_grad"], "failing": []}
    for run_name, run in runs.items():
        ref = exact if run_name.endswith("_f64") else runs["cpu"]
        line = {k: run[k] for k in ("loss", "num_pos", "ignored")}
        if run is not ref:
            limit = tol if "no_cudnn" in run_name else cudnn_limit
            vs_ref = momentum_errors(run["momentum"], ref["momentum"])
            stats = stats_errors(run["stats"], ref["stats"])
            worst = max(vs_ref, key=vs_ref.get)
            line.update({
                "limit": limit, "max_vs_cpu": vs_ref[worst],
                "worst": worst,
                "within_limit": sum(v <= limit for v in vs_ref.values()),
                "global_vs_cpu": global_error(run["momentum"],
                                              ref["momentum"]),
                "max_stats_vs_cpu": max(stats.values(), default=0.0)})
            failing = ["{} stat {} {}".format(run_name, k, v)
                       for k, v in stats.items() if not v <= limit]
            if run_name.endswith("_f64"):
                failing += ["{} {} {}".format(run_name, k, v)
                            for k, v in vs_ref.items() if not v <= limit]
            if (run["num_pos"], run["ignored"]) != (ref["num_pos"],
                                                    ref["ignored"]) or \
                    not math.isclose(run["loss"], ref["loss"],
                                     rel_tol=1e-4):
                failing.append("{} loss {} num_pos {} ignored {}".format(
                    run_name, run["loss"], run["num_pos"], run["ignored"]))
            result["failing"] += failing
        if run is not exact:
            vs_f64 = momentum_errors(run["momentum"], exact["momentum"])
            line.update({"max_vs_f64": max(vs_f64.values()),
                         "global_vs_f64": global_error(run["momentum"],
                                                       exact["momentum"]),
                         "relu_flips_vs_f64": relu_flips(run["masks"],
                                                          exact["masks"])})
        result[run_name] = line
    result["relu_outputs"] = sum(int(m.numel())
                                 for m in exact["masks"].values())
    emit(result)
    if runs["cpu"]["no_grad"] or exact["no_grad"]:
        raise AssertionError("{}: tensors without a gradient on the CPU: "
                             "{}".format(name, runs["cpu"]["no_grad"]))
    if result["failing"]:
        raise AssertionError("{}: card step off the CPU's: {}".format(
            name, result["failing"][:20]))
    return result


def phase_family_train_parity():
    return [family_train_parity(name) for name in ("rfbnet300_vgg16_voc",
                                                   "refinedet320_vgg16_voc")]


class WatchedSolver:
    """An ``EvalVOC`` that records, around each validation, whether the
    model's running statistics came out bit-equal and its mode was
    handed back."""

    def __init__(self, solver):
        self.solver, self.seen = solver, []

    @property
    def last_timing(self):
        return self.solver.last_timing

    def validate(self, eval_fn):
        model = eval_fn.model
        before, mode = running_stats(model), model.training
        out = self.solver.validate(eval_fn)
        after = running_stats(model)
        self.seen.append({"stats_equal": all(torch.equal(v, after[k])
                                             for k, v in before.items()),
                          "running_stats": len(before),
                          "mode_kept": model.training == mode})
        return out


def write_voc_tree(root, sets, seed=0, sizes=((300, 300),)):
    """A seeded VOC tree under ``root``: for each (set name, count), that
    many uint8 images of noise, (h, w) cycling through ``sizes``, with
    1-4 solid class-coloured boxes (each after the first marked difficult
    with probability 0.2), their XML and the ImageSets list. The images
    are binary PPM under VOC's ``JPEGImages/<id>.jpg`` names, which
    ``data.image.imread`` reads without OpenCV. Returns the image count."""
    rng = np.random.RandomState(seed)
    palette = rng.randint(30, 255, (len(VOC_CLASSES), 3))
    base = os.path.join(root, "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                            "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    n = 0
    for setname, count in sets:
        ids = []
        for _ in range(count):
            img_id = "%06d" % n
            h, w = sizes[n % len(sizes)]
            n += 1
            ids.append(img_id)
            img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
            objs = []
            for k in range(rng.randint(1, 5)):
                x1 = rng.randint(0, w - 60)
                y1 = rng.randint(0, h - 60)
                x2 = rng.randint(x1 + 30, min(x1 + w // 2, w) + 1)
                y2 = rng.randint(y1 + 30, min(y1 + h // 2, h) + 1)
                cls = rng.randint(len(VOC_CLASSES))
                img[y1:y2, x1:x2] = palette[cls]
                objs.append(
                    "<object><name>{}</name><difficult>{}</difficult>"
                    "<bndbox><xmin>{}</xmin><ymin>{}</ymin><xmax>{}</xmax>"
                    "<ymax>{}</ymax></bndbox></object>".format(
                        VOC_CLASSES[cls], int(k > 0 and rng.rand() < 0.2),
                        x1 + 1, y1 + 1, x2, y2))
            write_ppm(os.path.join(base, "JPEGImages", img_id + ".jpg"), img)
            with open(os.path.join(base, "Annotations", img_id + ".xml"),
                      "w") as f:
                f.write("<annotation><size><width>{}</width><height>{}"
                        "</height><depth>3</depth></size>{}</annotation>"
                        .format(w, h, "".join(objs)))
        with open(os.path.join(base, "ImageSets", "Main", setname + ".txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    return n


def phase_fit(name="ssd_vgg16_voc", n_train=64, n_test=64):
    """Two fit() runs of configuration ``name`` on a seeded VOC tree: 4
    steps from a --basenet npz (save at 2 and 4, validate at 4), then an
    auto-resume to 6 (save and validate at 6). One ``nms_rows`` launch
    per eval batch; each validation leaves the running statistics
    bit-equal, and a restore of the first run's last checkpoint gives
    them back bit-equal."""
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_fit_",
                            dir=build.BUILD_DIR.parent)
    try:
        cfg = train_cfg("bfloat16", name)
        size = cfg.MODEL.IMAGE_SIZE[0]
        write_voc_tree(os.path.join(work, "voc"),
                       (("trainval", n_train), ("test", n_test)),
                       sizes=((size, size),))
        cfg.DATASET.TEST_SETS = (("2007", "test"),)
        cfg.TRAIN.SAVE_ITER = 2
        cfg.TRAIN.EVAL_ITER = 4
        cfg.TRAIN.LOG_LOSS_ITER = 1
        # the basenet: the conv1_1 of the seeded weights the serving path
        # uses, so the boxes stay finite (infer.random_state_dict)
        w = random_state_dict(cfg, seed=0)["backbone.conv1_1.conv.weight"]
        basenet = os.path.join(work, "basenet.npz")
        np.savez(basenet, **{"backbone/conv1_1/conv/kernel":
                             w.permute(2, 3, 1, 0).numpy()})
        root = os.path.join(work, "voc")

        def loaders():
            train = DetLoader(
                VOCDetection(root, (("2007", "trainval"),)),
                NetworkInput((size, size)), BATCH, shuffle=True,
                drop_last=True, num_workers=4)
            test = DetLoader(VOCDetection(root, cfg.DATASET.TEST_SETS),
                             NetworkInput((size, size)), BATCH,
                             num_workers=4)
            return train, WatchedSolver(EvalVOC(test, cfg, os.path.join(
                work, "out", "eval")))

        out_dir = os.path.join(work, "out")
        eval_batches = -(-n_test // BATCH)
        runs = []
        for max_iter, kw in ((4, {"basenet": basenet}),
                             (6, {"auto_resume": True})):
            cfg.TRAIN.MAX_ITER = max_iter
            train, solver = loaders()
            reset_counts()
            t0 = time.perf_counter()
            res = fit(cfg, train, solver, out_dir, device="cuda", **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = counts()
            run = {"max_iter": max_iter, **{k: str(v) if k == "basenet"
                                            else v for k, v in kw.items()},
                   "seconds": seconds, "step": res["step"],
                   "evals": res["evals"], "ckpt_steps": res["ckpt_steps"],
                   "losses": res["losses"], "launches": launches,
                   "eval_batches": eval_batches * len(res["evals"]),
                   "validations": solver.seen}
            runs.append(run)
            if max_iter == 4:  # the first run's state against its save
                saved = running_stats(res["state"].model)
                fresh, _ = create_train_state(cfg, "cuda", seed=1)
                Checkpointer(os.path.join(out_dir, "ckpt")).restore(fresh)
                restored = running_stats(fresh.model)
                run["restore_stats_equal"] = fresh.step == 4 and all(
                    torch.equal(v, restored[k]) for k, v in saved.items())
                run["running_stats"] = len(saved)
                del fresh
                if not run["restore_stats_equal"]:
                    raise AssertionError("{}: a restore changed the running "
                                         "statistics".format(name))
            if not all(v["stats_equal"] and v["mode_kept"]
                       for v in solver.seen):
                raise AssertionError("{}: a validation moved the running "
                                     "statistics or the model's mode: "
                                     "{}".format(name, solver.seen))
            if launches["nms_rows"] != run["eval_batches"] \
                    or launches["nms_mask"] != 0:
                raise AssertionError("fit made NMS launches {} for {} eval "
                                     "batches".format(launches,
                                                      run["eval_batches"]))
            for e in res["evals"]:
                if not 0.0 <= e["mAP"] <= 1.0 or e["dropped"] < 0:
                    raise AssertionError("fit eval {}".format(e))
            if not all(math.isfinite(m["loss"]) and m["num_pos"] > 0
                       for m in res["losses"]):
                raise AssertionError("fit losses {}".format(res["losses"]))
        first, second = runs
        if first["ckpt_steps"] != [2, 4] or second["ckpt_steps"] \
                != [2, 4, 6] or second["step"] != 6 \
                or [e["step"] for e in first["evals"]] != [4] \
                or [e["step"] for e in second["evals"]] != [6] \
                or second["losses"][0]["step"] != 5:
            raise AssertionError("fit runs {}".format(runs))
        result = {"phase": "fit", "cfg": name, "dtype": "bfloat16",
                  "batch": BATCH,
                  "train_images": n_train, "test_images": n_test,
                  "runs": runs, "nms_rows_launches": sum(
                      r["launches"]["nms_rows"] for r in runs),
                  "eval_batches": sum(r["eval_batches"] for r in runs)}
        emit(result)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


# VOC's common image sizes (h, w) and a few odd ones, for the data phases
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (281, 500),
             (217, 301), (480, 96), (353, 499))


def sampler_windows(root, n):
    """The sampler's arguments for the first ``n`` items of a tree's
    trainval set: the windows SSDAugmentation's device-photometric path
    draws (seeded), then the edge cases: a 1-pixel window, a window wholly
    in the fill, a flip, and resizes by exactly 2x up and down."""
    ds = VOCDetection(root, (("2007", "trainval"),))
    fill = np.rint(np.array(default_cfg().DATASET.PIXEL_MEANS)).astype(
        np.uint8)
    cases = []
    for i in range(n):
        item = ds[i]
        h, w, _ = item["image"].shape
        rng = np.random.default_rng(i)
        boxes = item["boxes"] * np.array([w, h, w, h], np.float32)
        (top, left, rect), _, _ = augment.sample_expand_crop_geometry(
            (h, w), boxes, item["labels"], rng)
        cases.append((item["image"], top, left, rect,
                      bool(rng.integers(2)), fill, (300, 300)))
    img = ds[0]["image"]
    h, w, _ = img.shape
    cases += [(img, 0, 0, (5, 7, 6, 8), False, fill, (300, 300)),
              (img, h + 10, w + 10, (0, 0, w, h), False, fill, (300, 300)),
              (img, 3, 4, (0, 0, w + 8, h + 6), True, fill, (300, 300)),
              (img, 0, 0, (0, 0, w, h), False, fill, (2 * h, 2 * w)),
              (img[:h - h % 2, :w - w % 2], 0, 0,
               (0, 0, w - w % 2, h - h % 2), False, fill,
               (h // 2, w // 2))]
    return cases


def item_ms(root, n=32):
    """ms an item, in one thread, of the loader's parts for the first
    ``n`` items of a tree's trainval set: reading (the PPM decode and the
    XML), and each mode's transform (seeded draws)."""
    ds = VOCDetection(root, (("2007", "trainval"),))
    t0 = time.perf_counter()
    items = [ds[i] for i in range(n)]
    out = {"read": 1e3 * (time.perf_counter() - t0) / n}
    for mode, kw in (("float", {}), ("uint8", {"device_photometric": True})):
        aug = augment.SSDAugmentation(**kw)
        t0 = time.perf_counter()
        for i, item in enumerate(items):
            aug(item["image"], item["boxes"], item["labels"],
                np.random.default_rng(i))
        out[mode] = 1e3 * (time.perf_counter() - t0) / n
    return out


def loader_threads_joined(timeout=60.0):
    """Wait for every loader thread to end (each finishes the batch it
    holds), so that none still works in the next measurement."""
    for t in threading.enumerate():
        if t.name.startswith("DetLoader-worker-"):
            t.join(timeout)
            if t.is_alive():
                raise AssertionError(t.name + " did not stop")


def loader_rate(cfg, batches):
    """``dataset_factory("train", cfg)`` over ``batches`` batches after
    its first round (one batch a worker, made side by side), inside one
    epoch: images/s, and the process's CPU seconds a second over them,
    the cores the workers kept busy."""
    loader = dataset_factory("train", cfg)
    skip = cfg.DATASET.NUM_WORKERS
    if skip + batches > len(loader):
        raise ValueError("{} + {} batches cross the epoch of {}".format(
            skip, batches, len(loader)))
    it = iter(loader)
    for _ in range(skip):
        next(it)
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(batches):
        next(it)
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    it.close()
    loader_threads_joined()
    return {"images_per_s": batches * cfg.DATASET.TRAIN_BATCH_SIZE / wall,
            "cores_busy": cpu / wall, "skipped": skip, "batches": batches,
            "epoch_batches": len(loader)}


def step_loop(state, step, batches, n, keep=0):
    """``n`` train steps over the iterator ``batches``, the metrics read a
    step late as ``fit`` reads them. Returns, as each step starts and
    after the last read, (time, {the seconds so far spent waiting for a
    batch, in the step's call (its H2D copies and the dispatch of its
    ops), reading the metrics (waiting for the device)}, CPU time); the
    metrics; and the last ``keep`` batches."""
    acc = {"wait": 0.0, "call": 0.0, "read": 0.0}
    marks, metrics, prev, kept = [], [], None, []
    for i in range(n):
        marks.append((time.perf_counter(), dict(acc), time.process_time()))
        t0 = time.perf_counter()
        b = next(batches)
        t1 = time.perf_counter()
        m = step(state, torch.from_numpy(b["images"]),
                 torch.from_numpy(b["boxes"]), torch.from_numpy(b["labels"]))
        t2 = time.perf_counter()
        if prev is not None:
            metrics.append({k: float(v) for k, v in prev.items()})
        acc["wait"] += t1 - t0
        acc["call"] += t2 - t1
        acc["read"] += time.perf_counter() - t2
        prev = m
        if i >= n - keep:
            kept.append(b)
    t2 = time.perf_counter()
    metrics.append({k: float(v) for k, v in prev.items()})
    acc["read"] += time.perf_counter() - t2
    marks.append((time.perf_counter(), acc, time.process_time()))
    return marks, metrics, kept


def loop_window(marks, first, batch):
    """A step loop's figures from its step ``first`` to its end."""
    (t, acc, c), (t1, acc1, c1) = marks[first], marks[-1]
    n, total = len(marks) - 1 - first, t1 - t
    out = {"steps": n, "ms_per_step": 1e3 * total / n,
           "images_per_s": n * batch / total,
           "wait_share": (acc1["wait"] - acc["wait"]) / total,
           "cores_busy": (c1 - c) / total}
    for k in acc:
        out[k + "_ms_per_step"] = 1e3 * (acc1[k] - acc[k]) / n
    return out


def fed_steps(cfg, warmup, drain, steps):
    """bf16 SSD300 train steps fed by the train loader, inside one epoch:
    ``warmup`` steps, then ``drain`` + ``steps`` steps. The last ``steps``
    are the steady figures, the loader's prefetch queue (PREFETCH +
    workers batches, filled during the warm-up) having had ``drain``
    steps to empty: ms per step on the host's clock, the ms a step spent
    waiting for a batch, in the step's call and reading its metrics, the
    wait's share and the process's busy cores; beside them the same over
    all ``drain + steps``, and ``alone``: the same loop over those last
    ``steps`` batches again once the loader's threads have ended. Every
    loss and positive count of the fed steps."""
    state, priors = create_train_state(cfg, "cuda", seed=0)
    step = make_train_step(priors, cfg)
    loader = dataset_factory("train", cfg)
    if warmup + drain + steps > len(loader):
        raise ValueError("{} steps cross the epoch of {} batches".format(
            warmup + drain + steps, len(loader)))
    it = iter(loader)
    for _ in range(warmup):
        b = next(it)
        step(state, torch.from_numpy(b["images"]),
             torch.from_numpy(b["boxes"]), torch.from_numpy(b["labels"]))
    torch.cuda.synchronize()
    marks, metrics, kept = step_loop(state, step, it, drain + steps, steps)
    it.close()
    loader_threads_joined()
    alone, _, _ = step_loop(state, step, iter(kept), steps)
    del state
    batch = cfg.DATASET.TRAIN_BATCH_SIZE
    return {**loop_window(marks, drain, batch),
            "all": loop_window(marks, 0, batch),
            "alone": loop_window(alone, 0, batch),
            "warmup": warmup, "drain": drain,
            "epoch_batches": len(loader),
            "losses": [m["loss"] for m in metrics],
            "num_pos": [int(m["num_pos"]) for m in metrics]}


def phase_data(n_train=1536, n_windows=64, rate_batches=(4, 24), steps=20):
    """The host pipeline on the card's host, with no OpenCV: a seeded VOC
    tree of PPM images at VOC's sizes, 48 batches an epoch, so that no
    measurement crosses an epoch's end (where the loader restarts its
    threads); the C++ sampler bit for bit against its numpy twin on the
    sampled windows and the edge cases, each timed per item; the train
    loader's images/s and busy cores in both modes at 1 and 8 workers;
    then SSD300 bf16 train steps at batch 32 fed by the loader in each
    mode, with the loop's wait for the loader once its prefetch queue has
    drained."""
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_data_",
                            dir=build.BUILD_DIR.parent)
    try:
        root = os.path.join(work, "voc")
        t0 = time.perf_counter()
        write_voc_tree(root, (("trainval", n_train),), seed=5,
                       sizes=VOC_SIZES)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.build()
        build_s = time.perf_counter() - t0
        cases = sampler_windows(root, n_windows)
        t0 = time.perf_counter()
        got = [native.fused_sample_u8(*c) for c in cases]
        native_ms = 1e3 * (time.perf_counter() - t0) / len(cases)
        t0 = time.perf_counter()
        want = [native.fused_sample_u8_plain(*c) for c in cases]
        plain_ms = 1e3 * (time.perf_counter() - t0) / len(cases)
        unequal = [i for i, (a, b) in enumerate(zip(got, want))
                   if not np.array_equal(a, b)]
        if unequal:
            raise AssertionError("fused_sample_u8 differs from its plain "
                                 "version on cases {}".format(unequal))
        max_err = max(int(np.abs(a.astype(np.int16) - b).max())
                      for a, b in zip(got, want))
        out_bytes = sum(a.nbytes for a in got)
        in_bytes = sum(min(c[0].nbytes, 3 * (c[3][2] - c[3][0])
                           * (c[3][3] - c[3][1])) for c in cases)
        sampler = {"cases": len(cases), "windows": n_windows,
                   "edge_cases": len(cases) - n_windows,
                   "max_abs_err": max_err, "ms_per_item": native_ms,
                   "plain_ms_per_item": plain_ms,
                   "bytes_per_item": (in_bytes + out_bytes) / len(cases),
                   "build_seconds": build_s}

        parts = item_ms(root)
        rates, runs = [], {}
        for mode, device_photometric in (("float", False), ("uint8", True)):
            cfg = load_cfg("ssd_vgg16_voc")
            cfg.DATASET.DATASET_DIR = root
            cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
            cfg.DATASET.DEVICE_PHOTOMETRIC = device_photometric
            cfg.TRAIN.OPTIMIZER.LR = 1e-5
            for workers, batches in zip((1, 8), rate_batches):
                cfg.DATASET.NUM_WORKERS = workers
                rates.append({"mode": mode, "workers": workers,
                              **loader_rate(cfg, batches)})
            cfg.DATASET.NUM_WORKERS = 8
            native.CALLS = 0
            run = fed_steps(cfg, 3, DetLoader.PREFETCH + 8, steps)
            run["sampler_calls"] = native.CALLS
            if not all(math.isfinite(v) for v in run["losses"]) \
                    or min(run["num_pos"]) <= 0:
                raise AssertionError("{} losses {} num_pos {}".format(
                    mode, run["losses"], run["num_pos"]))
            runs[mode] = run
        if runs["uint8"]["sampler_calls"] == 0 \
                or runs["float"]["sampler_calls"] != 0:
            raise AssertionError("sampler calls {} {}".format(
                runs["uint8"]["sampler_calls"],
                runs["float"]["sampler_calls"]))
        result = {"phase": "data", "train_images": n_train,
                  "sizes": VOC_SIZES, "tree_seconds": tree_s,
                  "cpu_count": os.cpu_count(),
                  "affinity": len(os.sched_getaffinity(0)),
                  "sampler": sampler, "item_ms": parts, "loader": rates,
                  "batch": BATCH,
                  "dtype": "bfloat16", "steps": steps, "fed": runs,
                  "nvidia_smi": power_limit()}
        emit(result)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def trace_busy(path):
    """From a Chrome trace of ``torch.profiler``: the count of device
    kernel events, their summed ms, and the share of the traced window in
    which some kernel ran (overlapping kernels counted once)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    timed = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    if not spans:
        return {"kernels": 0}
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(b for _, b in timed) - min(a for a, _ in timed)
    return {"kernels": len(spans),
            "kernel_ms": sum(b - a for a, b in spans) / 1e3,
            "window_ms": window / 1e3, "busy_share": busy / window}


def phase_cli(n_train=1024, n_test=64, steps=20):
    """The two command lines at full width on a seeded VOC tree of PPM
    images at VOC's sizes: ``odtpu_torch.train``'s setup and run train
    SSD300 for 20 steps (bf16, batch 32, the float host path) inside one
    epoch of 32 batches, save at 10 and 20, validate at 20 and trace
    steps 11-20 with --profile_dir; then
    ``odtpu_torch.eval``'s setup and run score the last checkpoint. One
    ``nms_rows`` launch per eval batch and no ``nms_mask``; the eval's mAP
    and detection files equal the train run's last validation."""
    if steps > n_train // BATCH:
        raise ValueError("{} steps cross the epoch of {} batches".format(
            steps, n_train // BATCH))
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                            dir=build.BUILD_DIR.parent)
    try:
        root = os.path.join(work, "voc")
        write_voc_tree(root, (("trainval", n_train), ("test", n_test)),
                       seed=6, sizes=VOC_SIZES)
        w = random_state_dict(load_cfg(), seed=0)[
            "backbone.conv1_1.conv.weight"]
        basenet = os.path.join(work, "basenet.npz")
        np.savez(basenet, **{"conv1_1/kernel":
                             w.permute(2, 3, 1, 0).numpy()})
        out, prof = os.path.join(work, "out"), os.path.join(work, "prof")
        args = train.parse_args(["--output_dir", out, "--max_iter",
                                 str(steps), "--basenet", basenet,
                                 "--profile_dir", prof])
        cfg, out_dir, _ = train.setup(args)
        cfg.DATASET.DATASET_DIR = root
        cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
        cfg.TRAIN.SAVE_ITER = steps // 2
        cfg.TRAIN.EVAL_ITER = steps
        cfg.TRAIN.LOG_LOSS_ITER = 5
        cfg.TRAIN.OPTIMIZER.LR = 1e-5
        eval_batches = -(-n_test // cfg.DATASET.EVAL_BATCH_SIZE)
        reset_counts()
        t0 = time.perf_counter()
        res = train.run(args, cfg, out_dir, os.path.join(work, "logs"))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = counts()
        trace = os.path.join(prof, "trace.json")
        if not os.path.isfile(trace):
            raise AssertionError("no profiler trace at " + trace)
        busy = trace_busy(trace)
        if res["ckpt_steps"] != [steps // 2, steps] \
                or [e["step"] for e in res["evals"]] != [steps]:
            raise AssertionError("train run {}".format(
                {k: res[k] for k in ("ckpt_steps", "evals")}))
        if not res["losses"] or not all(
                math.isfinite(m["loss"]) and m["num_pos"] > 0
                for m in res["losses"]):
            raise AssertionError("cli losses {}".format(res["losses"]))

        eargs = cli.parse_args(["--ckpt", os.path.join(out, "ckpt"),
                                "--output_dir", os.path.join(work, "eval")])
        ecfg = cli.setup(eargs)
        ecfg.DATASET.DATASET_DIR = root
        reset_counts()
        t0 = time.perf_counter()
        scored = cli.run(eargs, ecfg)
        eval_s = time.perf_counter() - t0
        eval_launches = counts()
        last = res["evals"][-1]
        same_files = all(
            open(os.path.join(out, "eval", f)).read()
            == open(os.path.join(work, "eval", f)).read()
            for f in os.listdir(os.path.join(out, "eval"))
            if f.startswith("det_"))
        for label, launches in (("train", train_launches),
                                ("eval", eval_launches)):
            if launches != {"nms_mask": 0, "nms_rows": eval_batches}:
                raise AssertionError("{}: NMS launches {} for {} eval "
                                     "batches".format(label, launches,
                                                      eval_batches))
        if scored["maps"] != last["maps"] or not same_files:
            raise AssertionError("eval mAP {} (files equal: {}) against the "
                                 "train run's {}".format(
                                     scored["maps"], same_files,
                                     last["maps"]))
        result = {"phase": "cli", "cfg": args.cfg_name, "dtype": "bfloat16",
                  "batch": BATCH, "train_images": n_train,
                  "epoch_batches": n_train // BATCH,
                  "test_images": n_test, "steps": res["step"],
                  "train_seconds": train_s, "losses": res["losses"],
                  "ckpt_steps": res["ckpt_steps"], "train_mAP": last["maps"],
                  "eval_mAP": scored["maps"], "detection_files_equal": True,
                  "eval_seconds": eval_s, "eval_timing": scored["timing"],
                  "eval_batches": eval_batches,
                  "launches": {"train": train_launches,
                               "eval": eval_launches},
                  "trace": busy, "nvidia_smi": power_limit()}
        emit(result)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_coco_tree(root, split="minival2014", n=64, seed=7):
    """A seeded COCO tree: ``annotations/instances_<split>.json`` over the
    80 category ids and ``images/<split>/`` PPM images at 640x480 and
    480x640, 1-4 boxes each. Returns the parsed annotation dict."""
    rng = np.random.RandomState(seed)
    cat_ids = [i for i in range(1, 91) if i not in (
        12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
    img_dir = os.path.join(root, "images", split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = ((480, 640), (640, 480))[i % 2]
        img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 5)):
            x, y = rng.randint(0, w - 80), rng.randint(0, h - 80)
            bw, bh = rng.randint(20, 80, 2)
            img[y:y + bh, x:x + bw] = rng.randint(30, 255, 3)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.choice(cat_ids)),
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0})
        name = "COCO_{}_{:012d}.jpg".format(split, i + 1)
        write_ppm(os.path.join(img_dir, name), img)
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
    data = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in cat_ids]}
    with open(os.path.join(root, "annotations",
                           "instances_{}.json".format(split)), "w") as f:
        json.dump(data, f)
    return data


def truth_step(dataset, batch):
    """A perfect detector for EvalCOCO.validate: each batch, in the
    loader's order, answered with its ground truth as rows (score 1,
    [0, 1] boxes, class + 1)."""
    truth = [dataset[i] for i in range(len(dataset))]
    calls = [0]

    def step(images):
        rows = torch.zeros(images.shape[0], 200, 6)
        for k in range(images.shape[0]):
            i = calls[0] * batch + k
            if i < len(truth):
                n = len(truth[i]["labels"])
                rows[k, :n, 0] = 1.0
                rows[k, :n, 1:5] = torch.from_numpy(truth[i]["boxes"])
                rows[k, :n, 5] = torch.from_numpy(
                    truth[i]["labels"] + 1.0)
        calls[0] += 1
        return {"rows": rows,
                "dropped": torch.zeros(images.shape[0], dtype=torch.int32)}

    return step


def phase_coco(n=64):
    """The eval command line on SSD300-COCO (``ssd_vgg16_coco``) over a
    seeded COCO tree with the seeded served weights as an npz: mAP@0.5
    and mAP@[.5:.95] in [0, 1], one ``nms_rows`` launch per batch; then
    EvalCOCO fed the ground truth scores 1.0 and 1.0."""
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_coco_",
                            dir=build.BUILD_DIR.parent)
    try:
        root = os.path.join(work, "coco")
        write_coco_tree(root, n=n)
        cfg = load_cfg("ssd_vgg16_coco")
        npz = os.path.join(work, "served.npz")
        np.savez(npz, **to_odtpu_params(random_state_dict(cfg, seed=0)))
        eargs = cli.parse_args(["--cfg_name", "ssd_vgg16_coco",
                                "--model_npz", npz, "--output_dir",
                                os.path.join(work, "eval")])
        ecfg = cli.setup(eargs)
        ecfg.DATASET.DATASET_DIR = root
        batches = -(-n // ecfg.DATASET.EVAL_BATCH_SIZE)
        reset_counts()
        t0 = time.perf_counter()
        scored = cli.run(eargs, ecfg)
        seconds = time.perf_counter() - t0
        launches = counts()
        if launches != {"nms_mask": 0, "nms_rows": batches}:
            raise AssertionError("coco NMS launches {} for {} batches"
                                 .format(launches, batches))
        if not all(0.0 <= m <= 1.0 for m in scored["maps"]) \
                or len(scored["maps"]) != 2:
            raise AssertionError("coco mAP {}".format(scored["maps"]))
        loader = dataset_factory("eval", ecfg)
        solver = eval_solver_factory(loader, ecfg)
        _, perfect = solver.validate(truth_step(loader.dataset,
                                                loader.batch_size))
        if perfect != [1.0, 1.0]:
            raise AssertionError("perfect detector scored {}".format(
                perfect))
        result = {"phase": "coco", "cfg": "ssd_vgg16_coco",
                  "dtype": "bfloat16", "images": n, "batches": batches,
                  "mAP": scored["maps"], "eval_seconds": seconds,
                  "eval_timing": scored["timing"], "detections":
                  len(scored["results"]), "launches": launches,
                  "perfect_mAP": perfect, "nvidia_smi": power_limit()}
        emit(result)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


# the configurations the int8 phase serves: the main path's and the
# families'
INT8_CFGS = ("ssd_vgg16_voc",) + FAMILIES


@contextlib.contextmanager
def plain_int8():
    """Every quantized conv through ``ops.quant.conv_int8_plain`` (float64
    convs over the same integers) in place of ``torch._int_mm``."""
    route = quant.conv_int8
    quant.conv_int8 = quant.conv_int8_plain
    try:
        yield
    finally:
        quant.conv_int8 = route


def kept_share(want, got, iou=0.5):
    """The share of ``want``'s rows [B, R, 6] (score > 0) that a row of
    ``got`` of the same class overlaps by IoU >= ``iou``."""
    kept = total = 0
    for w, g in zip(want, got):
        w, g = w[w[:, 0] > 0], g[g[:, 0] > 0]
        total += w.shape[0]
        if not w.shape[0] or not g.shape[0]:
            continue
        lt = torch.maximum(w[:, None, 1:3], g[None, :, 1:3])
        rb = torch.minimum(w[:, None, 3:5], g[None, :, 3:5])
        inter = (rb - lt).clamp(min=0).prod(-1)
        area_w = (w[:, 3:5] - w[:, 1:3]).prod(-1)
        area_g = (g[:, 3:5] - g[:, 1:3]).prod(-1)
        union = area_w[:, None] + area_g[None, :] - inter
        hit = (inter >= iou * union) & (w[:, None, 5] == g[None, :, 5])
        kept += int(hit.any(1).sum())
    return kept / max(total, 1)


def quantized_convs(model):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, Conv) and m.quantizable]


def serve_int8(name, warmup=3, batches=10):
    """One configuration served in bfloat16, then in int8 convs: the two
    modes' numbers side by side, the int8 launches checked, the int8
    rows (batch 2) held to the plain int8 route's."""
    cfg = load_cfg(name)
    served, rows = {}, {}
    for mode in ("", "int8"):
        det, _, images, served[mode] = serve(name, cfg, warmup, batches,
                                             mode)
        served[mode]["forward_ms"] = cuda_ms(
            lambda: det.step.forward(images), 5)
        rows[mode] = det(images)["rows"]
        if not mode:  # free the bf16 model before the int8 one's batches
            del det
            gc.collect()
            torch.cuda.empty_cache()
    bf16, int8 = served[""], served["int8"]
    n_convs = len(quantized_convs(det.model))
    if bf16["int_mm_calls"] != 0 or int8["int_mm_calls"] != batches * n_convs:
        raise AssertionError(
            "{}: {} batches made {} (bf16) and {} (int8) _int_mm calls; "
            "want one per quantized conv ({}) a batch in int8 only".format(
                name, batches, bf16["int_mm_calls"], int8["int_mm_calls"],
                n_convs))
    with torch.inference_mode():
        got = det(images[:2])["rows"]
        with plain_int8():
            plain = det(images[:2])["rows"]
    if not torch.equal(got, plain):
        raise AssertionError("{}: int8 rows != the plain int8 route's: {} "
                             "of {} differ".format(
                                 name, int((got != plain).sum()),
                                 plain.numel()))
    result = {"phase": "int8", "cfg": name, "batch": BATCH,
              "batches": batches, "warmup": warmup,
              "quantized_convs": n_convs, "bfloat16": bf16, "int8": int8,
              "int8_over_bf16_ms": int8["ms_per_batch"] / bf16["ms_per_batch"],
              "rows_equal_plain": True,
              "bf16_rows_kept_by_int8": kept_share(rows[""], rows["int8"]),
              "nvidia_smi": power_limit()}
    emit(result)
    return det, images, result


def int8_split(det, images, iters=5):
    """SSD300's int8 convs by stage on their real inputs (batch 32), by
    CUDA events: quantize (the activation), tap gather, ``_int_mm``,
    rescale; each ``_int_mm`` beside its bound and its plain version (a
    float64 product of the same operands, which it must equal)."""
    inputs = []

    def grab(module, args):
        inputs.append((module, args[0]))

    convs = quantized_convs(det.model)
    hooks = [m.register_forward_pre_hook(grab) for _, m in convs]
    with torch.inference_mode():
        det.step.forward(images)
    for h in hooks:
        h.remove()
    names = {m: n for n, m in convs}
    rows, sums = [], dict.fromkeys(
        ("quantize", "taps", "int_mm", "rescale", "weight_uncached",
         "int_mm_bound", "int_mm_plain"), 0.0)
    max_err = 0
    with torch.inference_mode():
        for module, x in inputs:
            c = module.conv
            o, _, kh, kw = c.weight.shape
            x_q, s_x = quant.quantize_act_int8(x)
            b, s_w = quant.weight_operand(c.weight, module.int8_cache)
            taps = quant.tap_matrix(x_q, (kh, kw), c.stride, c.padding,
                                    c.dilation)
            y = quant.int_mm(taps, b)
            ho = quant.out_size(x.shape[2], kh, c.stride[0], c.padding[0],
                                c.dilation[0])
            wo = quant.out_size(x.shape[3], kw, c.stride[1], c.padding[1],
                                c.dilation[1])
            y4 = y[:, :o].reshape(x.shape[0], ho, wo, o).permute(0, 3, 1, 2)
            ms = {
                "quantize": cuda_ms(lambda: quant.quantize_act_int8(x),
                                    iters),
                "weight_uncached": cuda_ms(
                    lambda: quant.weight_operand(c.weight), iters),
                "taps": cuda_ms(lambda: quant.tap_matrix(
                    x_q, (kh, kw), c.stride, c.padding, c.dilation), iters),
                "int_mm": cuda_ms(lambda: quant.int_mm(taps, b), iters),
                "rescale": cuda_ms(lambda: quant.rescale(
                    y4, s_x, s_w, module.dtype), iters),
                "int_mm_plain": cuda_ms(
                    lambda: taps.double() @ b.double(), 2)}
            max_err = max(max_err, int(
                (y.double() - taps.double() @ b.double()).abs().max()))
            m, kp = taps.shape
            ops = 2 * m * kh * kw * c.in_channels * o
            nbytes = taps.numel() + b.numel() + y.numel() * 4
            ops_ms = 1e3 * ops / PEAK_INT8_OPS_PER_S
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
            ms["int_mm_bound"] = max(ops_ms, bytes_ms)
            for k in sums:
                sums[k] += ms[k]
            rows.append({"conv": names[module], "M": m, "K": kp,
                         "N": b.shape[1], "O": o, **ms,
                         "int_mm_bound_by": ("operations" if ops_ms > bytes_ms
                                             else "bytes"),
                         "int_mm_tops": ops / ms["int_mm"] / 1e9,
                         "taps_bytes": taps.numel()})
    if max_err:
        raise AssertionError("_int_mm != its float64 product by {}".format(
            max_err))
    ops_bound = sum(r["int_mm_bound"] for r in rows
                    if r["int_mm_bound_by"] == "operations")
    result = {"phase": "int8_split", "cfg": "ssd_vgg16_voc",
              "batch": images.shape[0], "convs": len(rows),
              "sum_ms": sums,
              "stages_sum_ms": sum(sums[k] for k in (
                  "quantize", "taps", "int_mm", "rescale")),
              "taps_bytes": sum(r["taps_bytes"] for r in rows),
              "int_mm_max_abs_err": max_err,
              "int_mm_bound_by": ("operations" if ops_bound
                                  > sums["int_mm_bound"] / 2 else "bytes"),
              "per_conv": rows, "nvidia_smi": power_limit()}
    emit(result)
    return result


def phase_int8():
    t0 = time.perf_counter()
    results, split = [], None
    for name in INT8_CFGS:
        det, images, result = serve_int8(name)
        if name == "ssd_vgg16_voc":
            split = int8_split(det, images)
        results.append(result)
        del det, images
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "int8_done", "configurations": len(results),
          "seconds": time.perf_counter() - t0, "nvidia_smi": power_limit()})
    return results, split


def post(url, data=None):
    """(status, JSON body, wall ms) of a GET, or of a POST of ``data``."""
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, json.loads(body), 1e3 * (time.perf_counter() - t0)


def percentiles(values):
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p90": float(np.percentile(v, 90)), "max": float(v.max())}


def serve_http(quant_mode, bodies, conf):
    """``odtpu_torch.serve`` in a thread on a free port of 127.0.0.1 in
    one mode: the requests timed, each response held to the direct
    ``infer`` on the same bytes, the NMS launches counted."""
    infer, _ = http_serve.build_engine(load_cfg("ssd_vgg16_voc"),
                                       quant=quant_mode, device="cuda")
    server = http_serve.make_server(infer, host="127.0.0.1", port=0,
                                    conf=conf)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:{}".format(server.server_address[1])
    try:
        if post(url + "/healthz")[:2] != (200, {"ok": True}):
            raise AssertionError("/healthz")
        reset_counts()
        int_mm = quant.INT_MM_CALLS
        answers = [post(url + "/detect", body) for body in bodies]
        launches = counts()
        int_mm = quant.INT_MM_CALLS - int_mm
        for i, (body, (status, got, _)) in enumerate(zip(bodies, answers)):
            if status != 200 or not got["detections"]:
                raise AssertionError("request {}: {} {}".format(
                    i, status, str(got)[:200]))
            if got["detections"] != infer(imdecode(body), conf):
                raise AssertionError("request {}: the server's detections "
                                     "!= infer's on the same bytes".format(i))
        if post(url + "/nothing")[0] != 404 \
                or post(url + "/detect", b"no image")[0] != 400:
            raise AssertionError("the 404 or the 400 did not come")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if launches != {"nms_mask": 0, "nms_rows": len(bodies)}:
        raise AssertionError("{} requests made NMS launches {}".format(
            len(bodies), launches))
    return {"requests": len(bodies), "launches": launches,
            "int_mm_calls": int_mm,
            "wall_ms": percentiles([a[2] for a in answers]),
            "latency_ms": percentiles([a[1]["latency_ms"] for a in answers]),
            "detections_per_response": float(np.mean(
                [len(a[1]["detections"]) for a in answers]))}


def phase_serve(requests=20, conf=CONF):
    """The HTTP server in bfloat16 and in int8 on seeded PPM images at
    VOC's sizes."""
    bodies = []
    for i in range(requests):
        h, w = VOC_SIZES[i % 2]
        img = random_images(1, (h, w), 100 + i)[0]
        bodies.append(b"P6\n%d %d\n255\n" % (w, h)
                      + np.ascontiguousarray(img[:, :, ::-1]).tobytes())
    result = {"phase": "serve", "cfg": "ssd_vgg16_voc", "conf": conf,
              "sizes": [list(s) for s in VOC_SIZES[:2]]}
    for label, mode in (("bfloat16", ""), ("int8", "int8")):
        result[label] = serve_http(mode, bodies, conf)
        gc.collect()
        torch.cuda.empty_cache()
    result["nvidia_smi"] = power_limit()
    emit(result)
    return result


# what the export phase's subprocess runs: it imports only what
# ``load_artifact`` needs, loads each artifact, serves ``batches`` calls
# of each batch size with the NMS counts reset just before them and read
# just after, saves the last call's rows beside the artifact and prints
# one JSON line, with every port or JAX module it found imported
EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from odtpu_torch.export import load_artifact
from odtpu_torch.ops.cuda import nms_kernel

spec = json.loads(sys.argv[1])
images = torch.from_numpy(np.load(spec["images"])).cuda()
out = {"artifacts": {}}
for name, path in spec["artifacts"]:
    t0 = time.perf_counter()
    call, meta = load_artifact(path, "cuda")
    res = {"load_s": time.perf_counter() - t0, "batch": meta["batch"],
           "by_batch": {}}
    for b in ([meta["batch"]] if meta["batch"] else spec["poly_batches"]):
        x = images[:b]
        for _ in range(spec["warmup"]):
            call(x)
        torch.cuda.synchronize()
        nms_kernel.LAUNCHES = nms_kernel.MASK_LAUNCHES = 0
        nms_kernel.ROWS_LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(spec["batches"]):
            rows = call(x)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / spec["batches"]
        torch.save(rows.cpu(), "{}.{}.pt".format(path, b))
        res["by_batch"][str(b)] = {
            "ms_per_batch": ms, "calls": spec["batches"],
            "launches": {"nms_mask": nms_kernel.MASK_LAUNCHES,
                         "nms_rows": nms_kernel.ROWS_LAUNCHES}}
    out["artifacts"][name] = res
out["imported"] = sorted(m for m in sys.modules if m.startswith(
    ("odtpu_torch.models", "odtpu_torch.utils", "odtpu_torch.data",
     "odtpu.", "jax")))
print(json.dumps(out))
"""


def live_ms(det, images, warmup, batches):
    """(ms per batch, the last rows) of ``det`` on ``images``, host clock
    around ``batches`` calls ending in a synchronize."""
    for _ in range(warmup):
        det(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        rows = det(images)["rows"]
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / batches, rows


def phase_export(warmup=3, batches=10):
    """Seeded full-width SSD300 exported by ``odtpu_torch.export`` at
    batch 32 in bfloat16 and in int8 convs, and for any batch in
    bfloat16; each artifact loaded and served in one fresh subprocess
    that imports only what ``load_artifact`` needs. Its rows must equal
    the live ``Detector``'s on the same batch exactly, with one
    ``nms_rows`` launch a call, the polymorphic artifact's at B=1 and
    B=32; ms per batch beside the live path's, the artifact's size."""
    cfg = default_cfg()
    weights = random_state_dict(cfg, seed=0)
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_export_",
                            dir=build.BUILD_DIR.parent)
    try:
        npz = os.path.join(work, "ssd300.npz")
        np.savez(npz, **to_odtpu_params(weights))
        images = random_images(BATCH, cfg.MODEL.IMAGE_SIZE, 11)
        np.save(os.path.join(work, "images.npy"), images)
        arts = {}
        for name, batch, mode in (("bfloat16", BATCH, ""),
                                  ("int8", BATCH, "int8"),
                                  ("bfloat16_any_batch", 0, "")):
            path = os.path.join(work, name + ".zip")
            t0 = time.perf_counter()
            meta = export.export_artifact(path, cfg, ckpt=npz, batch=batch,
                                          quant=mode, device="cuda")
            arts[name] = {"path": path, "quant": mode, "batch": batch,
                          "export_s": time.perf_counter() - t0,
                          "bytes": os.path.getsize(path),
                          "num_weights": meta["num_weights"]}
        spec = {"images": os.path.join(work, "images.npy"),
                "artifacts": [(n, a["path"]) for n, a in arts.items()],
                "poly_batches": [1, BATCH], "warmup": warmup,
                "batches": batches}
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, json.dumps(spec)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError("the artifacts' subprocess failed:\n"
                                 + child.stderr[-4000:])
        served = json.loads(child.stdout.strip().splitlines()[-1])
        if served["imported"]:
            raise AssertionError("load_artifact imported {}".format(
                served["imported"]))
        x = torch.from_numpy(images).cuda()
        live = {}
        for mode in ("", "int8"):
            det = Detector(cfg, weights, device="cuda", quant=mode)
            for b in ([BATCH] if mode else [1, BATCH]):
                ms, rows = live_ms(det, x[:b], warmup, batches)
                live[(mode, b)] = {"ms_per_batch": ms, "rows": rows.cpu()}
            del det
        for name, art in arts.items():
            res = served["artifacts"][name]
            art.update(load_s=res["load_s"], served=res["by_batch"])
            for b, one in res["by_batch"].items():
                want = live[(art["quant"], int(b))]
                got = torch.load("{}.{}.pt".format(art["path"], b))
                one["live_ms_per_batch"] = want["ms_per_batch"]
                one["rows_equal_live"] = torch.equal(got, want["rows"])
                one["kept_rows"] = int((got[..., 0] > 0).sum())
                if not one["rows_equal_live"]:
                    raise AssertionError(
                        "{} artifact at B={}: {} of {} row values differ "
                        "from the live Detector's".format(
                            name, b, int((got != want["rows"]).sum()),
                            got.numel()))
                if one["launches"] != {"nms_mask": 0,
                                       "nms_rows": one["calls"]}:
                    raise AssertionError(
                        "{} artifact at B={}: {} calls made NMS launches "
                        "{}".format(name, b, one["calls"], one["launches"]))
            del art["path"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = {"phase": "export", "cfg": "ssd_vgg16_voc", "warmup": warmup,
              "batches": batches, "artifacts": arts,
              "subprocess_s": child_s, "nvidia_smi": power_limit()}
    emit(result)
    return result


def timed_steps(name, remat=False, rep_w=0.0, batch_fn=None, warmup=3,
                steps=10):
    """bf16 train steps of ``BATCH`` images of ``name`` from
    ``create_train_state``'s init (clipped at 10, as ``family_train``),
    with ``TPU.REMAT`` and ``LOSS.REPULSION_WEIGHT`` as given: ms/step by
    CUDA events, peak memory, every loss finite, no NMS launch. With the
    repulsion loss the steps start from ``random_state_dict``'s weights:
    the loss decodes the predicted boxes, and at the init's raw pixel
    scale |loc| reaches ~1000, where decode's exp overflows (in ``odtpu``
    too) and the gradient turns NaN."""
    cfg = train_cfg("bfloat16", name)
    cfg.TRAIN.OPTIMIZER.CLIP_GRAD_NORM = 10.0
    cfg.TPU.REMAT = remat
    cfg.LOSS.REPULSION_WEIGHT = rep_w
    state, priors = create_train_state(cfg, "cuda", seed=0)
    if rep_w > 0:
        state.model.load_state_dict(random_state_dict(cfg, seed=0))
    step = make_train_step(priors, cfg)
    images, boxes, labels = (batch_fn or train_batch)(
        BATCH, size=cfg.MODEL.IMAGE_SIZE)
    for _ in range(warmup):
        step(state, images, boxes, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = [step(state, images, boxes, labels) for _ in range(steps)]
    end.record()
    end.synchronize()
    launches = counts()
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if launches != {"nms_mask": 0, "nms_rows": 0} or not all(
            math.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError("{} remat={} rep={}: launches {} losses "
                             "{}".format(name, remat, rep_w, launches,
                                         losses))
    return state, step, (images, boxes, labels), {
        "ms_per_step": start.elapsed_time(end) / steps,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "steps": steps, "losses": losses}


def remat_parity(name, batch=4, tol=1e-5):
    """One float32 step (TF32 off, cuDNN deterministic) of ``name`` from
    the same seeded state and batch with ``TPU.REMAT`` and without it:
    each update (the momentum after the step) and each running statistic
    within ``tol`` relative L2 of the other's, the statistics moved once
    from their init."""
    cfg = train_cfg("float32", name)
    images, boxes, labels = (t.cuda() for t in parity_batch(batch, cfg=cfg))
    params = draw_params(batch, torch.Generator().manual_seed(5))
    params = {k: v.cuda() for k, v in params.items()}
    out = {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        for remat in (False, True):
            cfg.TPU.REMAT = remat
            state, priors = create_train_state(cfg, "cuda", seed=0)
            init = running_stats(state.model)
            step = make_train_step(priors, cfg)
            m = step(state, images, boxes, labels, aug_params=params)
            opt = state.optimizer.state
            out[remat] = {
                "loss": float(m["loss"]), "init": init,
                "stats": running_stats(state.model),
                "momentum": {k: opt[p]["momentum_buffer"].double()
                             for k, p in state.model.named_parameters()}}
            del state, step
    plain, remat = out[False], out[True]
    updates = {k: rel_l2(v, plain["momentum"][k])
               for k, v in remat["momentum"].items()}
    stats = {k: rel_l2(v, plain["stats"][k])
             for k, v in remat["stats"].items()}
    moved = sum(not torch.equal(v, remat["init"][k])
                for k, v in remat["stats"].items())
    worst_u = max(updates.values())
    worst_s = max(stats.values(), default=0.0)
    result = {"cfg": name, "batch": batch, "dtype": "float32",
              "loss": plain["loss"], "loss_remat": remat["loss"],
              "tensors": len(updates), "update_max_rel_l2": worst_u,
              "running_stats": len(stats), "stats_max_rel_l2": worst_s,
              "stats_moved": moved}
    if worst_u > tol or worst_s > tol or moved != len(stats):
        raise AssertionError("{}: remat against plain step: {}".format(
            name, result))
    return result


def phase_extras():
    """The training extras at full width, bf16, batch 32: SSD300 with
    ``REPULSION_WEIGHT = 0.5`` on :func:`parity_batch`'s several boxes an
    image (``loss_repul`` finite and > 0, the repelled priors counted),
    and SSD300 and RFBNet300 with ``TPU.REMAT`` off and on (ms/step,
    peak memory); then :func:`remat_parity` for both."""
    state, step, (images, boxes, labels), rep = timed_steps(
        "ssd_vgg16_voc", rep_w=0.5, steps=5, batch_fn=lambda b, size: tuple(
            t.cuda() for t in parity_batch(b)))
    if min(rep["losses"]["loss_repul"]) <= 0:
        raise AssertionError("loss_repul {}".format(
            rep["losses"]["loss_repul"]))
    with torch.no_grad():
        loc = step.forward(state, step.augment(images, state.step))[0]
        _, repelled = repulsion_loss(loc, step.priors, boxes, labels,
                                     step.variances)
    rep["repelled_priors"] = int(repelled)
    rep["gt_boxes"] = int((labels >= 0).sum())
    del state, step
    remat = {}
    for name in ("ssd_vgg16_voc", "rfbnet300_vgg16_voc"):
        remat[name] = {}
        for on in (False, True):
            # one warm-up step where this net's shapes already ran: cuDNN
            # has picked its algorithms and the allocator holds the blocks
            warm = name == "ssd_vgg16_voc" or on
            state, _, _, res = timed_steps(name, remat=on,
                                           warmup=1 if warm else 3)
            del res["losses"], state
            remat[name]["on" if on else "off"] = res
            gc.collect()
            torch.cuda.empty_cache()
        remat[name]["parity"] = remat_parity(name)
    result = {"phase": "extras", "batch": BATCH, "repulsion": rep,
              "remat": remat, "nvidia_smi": power_limit()}
    emit(result)
    return result


def main():
    t_start = time.perf_counter()
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t0
        return out

    info, _ = timed("device", phase_device)
    ptxas = timed("build", phase_build)
    cfg = default_cfg()
    priors = torch.from_numpy(
        prior_factory(cfg)(probe_layer_dims(cfg))).cuda()
    mask, rows = timed("kernel", phase_kernel, priors, ptxas)
    bf16 = timed("main_path_bf16", phase_main_path, "bfloat16")
    timed("main_path_f32", phase_main_path, "float32")
    families = timed("families", phase_families)
    train = timed("train", phase_train)
    timed("train_parity", phase_train_parity)
    family_train = timed("family_train", phase_family_train)
    timed("family_train_parity", phase_family_train_parity)
    fitted = timed("fit", phase_fit)
    fitted_rfb = timed("fit_rfbnet300", phase_fit, "rfbnet300_vgg16_voc")
    data = timed("data", phase_data)
    cli_run = timed("cli", phase_cli)
    coco = timed("coco", phase_coco)
    int8, split = timed("int8", phase_int8)
    served = timed("serve", phase_serve)
    exported = timed("export", phase_export)
    timed("extras", phase_extras)
    # each entry's count from the run of the path that reaches it, in
    # bfloat16: the serving path for nms_rows, DetectOut for nms_mask;
    # beside it, the counts on every path of the run
    mask["launches"] = bf16["dense"]["launches"]["nms_mask"]
    mask["path"] = "DetectOut (dense contract), {} calls".format(
        bf16["dense"]["calls"])
    rows["launches"] = bf16["launches"]["nms_rows"]
    rows["path"] = "Detector (serving), {} batches".format(bf16["batches"])
    for entry in (mask, rows):
        name = entry["name"]
        entry["launches_by_path"] = {
            "serving": bf16["launches"][name],
            "DetectOut": bf16["dense"]["launches"][name],
            "families": {f["cfg"]: f["launches"][name] for f in families},
            "train_step": train["launches"][name],
            "family_train": {f["cfg"]: f["launches"][name]
                             for f in family_train},
            "fit": sum(r["launches"][name] for r in fitted["runs"]),
            "fit_rfbnet300": sum(r["launches"][name]
                                 for r in fitted_rfb["runs"]),
            "cli_train": cli_run["launches"]["train"][name],
            "cli_eval": cli_run["launches"]["eval"][name],
            "coco_eval": coco["launches"][name],
            "int8": {r["cfg"]: r["int8"]["launches"][name] for r in int8},
            "serve": {mode: served[mode]["launches"][name]
                      for mode in ("bfloat16", "int8")},
            "export": {"{} B={}".format(art, b): one["launches"][name]
                       for art, a in exported["artifacts"].items()
                       for b, one in a["served"].items()}}
    emit({"phase": "seconds", **seconds,
          "total": time.perf_counter() - t_start})
    # the host sampler is C++ for the host, not a kernel of the card: it
    # stands under a key of its own
    sampler = data["sampler"]
    host = {"name": "fused_sample_u8", "route": "host",
            "source": "odtpu_torch/csrc/sampler.cc",
            "replaces": "odtpu/data/_native/sampler.cc (host C++, not a "
                        "TPU kernel)",
            "launches": data["fed"]["uint8"]["sampler_calls"],
            "path": "uint8 device-photometric loader, {} steps".format(
                data["fed"]["uint8"]["warmup"] + data["fed"]["uint8"]["drain"]
                + data["steps"]),
            "max_abs_err": sampler["max_abs_err"],
            "ms": sampler["ms_per_item"],
            "plain_ms": sampler["plain_ms_per_item"], "bound_ms": None,
            "bound_by": "not measured: no host memory rate",
            "library_ms": None, "cpu_count": data["cpu_count"]}
    # the int8 GEMM is cuBLASLt's, neither a TPU kernel nor written here:
    # it stands under a key of its own
    ssd_int8 = next(r for r in int8 if r["cfg"] == "ssd_vgg16_voc")
    library = {"name": "torch._int_mm", "route": "library",
               "source": "odtpu_torch/ops/quant.py",
               "replaces": "odtpu/ops/quant.py:63 lax.conv_general_dilated "
                           "(XLA's int8 conv, not a TPU kernel)",
               "launches": ssd_int8["int8"]["int_mm_calls"],
               "path": "Detector(quant='int8') on SSD300, {} batches".format(
                   ssd_int8["batches"]),
               "launches_by_path": {
                   "int8": {r["cfg"]: r["int8"]["int_mm_calls"]
                            for r in int8},
                   "serve": {mode: served[mode]["int_mm_calls"]
                             for mode in ("bfloat16", "int8")}},
               "max_abs_err": split["int_mm_max_abs_err"],
               "ms": split["sum_ms"]["int_mm"],
               "plain_ms": split["sum_ms"]["int_mm_plain"],
               "bound_ms": split["sum_ms"]["int_mm_bound"],
               "bound_by": split["int_mm_bound_by"],
               "library_ms": split["sum_ms"]["int_mm"],
               "note": "SSD300's {} quantized convs at batch 32, summed; "
                       "library_ms is the call itself".format(
                           split["convs"])}
    # the eval-mode batch-norm kernel: no TPU kernel's port (flax's norm
    # is fused by XLA), on the serving path of every batch-normed family;
    # timed on the largest norm input the families gave it
    norm_results = [f for f in families if f["bn_eval"]]
    largest = max(norm_results, key=lambda f: f["bn_eval"]["bytes"])
    norm = {"name": "bn_eval", "route": "cuda",
            "source": "odtpu_torch/csrc/batch_norm.cu",
            "replaces": "odtpu/models/common.py:177 flax nn.BatchNorm in "
                        "eval mode (fused by XLA; no Pallas kernel)",
            "launches": sum(f["bn_eval_launches"] for f in families),
            "path": "families, {} batches a configuration".format(
                families[0]["batches"]),
            "launches_by_path": {
                "families": {f["cfg"]: f["bn_eval_launches"]
                             for f in families},
                "int8": {r["cfg"]: r["int8"]["bn_eval_launches"]
                         for r in int8},
                "serving_ssd300": bf16["bn_eval_launches"]},
            "timed_on": "{} {}".format(largest["cfg"],
                                       largest["bn_eval"]["largest"]),
            **largest["bn_eval"]}
    emit({"kernels": [mask, rows, norm], "host": [host],
          "library": [library]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    sys.stdout.flush()
    sys.stderr.flush()
    # nothing may follow the last line: skip interpreter teardown, where
    # an atexit hook or a late warning could still print
    os._exit(0)


if __name__ == "__main__":
    main()
