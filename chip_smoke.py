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
4. topk: ``ops.topk.top_k_exact``, ``odtpu``'s two-level exact split (G
   groups of ~n/G, then the G*k survivors), at every shape the detect
   paths give it at B = 32 (640 or 2,560 candidate sets over 6,375 to
   32,756 priors, the cross-class compaction over 4,000 or 16,000 rows,
   survivors-first over 200): values and indices bit-equal to one flat
   stable sort on uniform, tie-heavy and all-equal scores; both timed
   on the device alone and as launched, with the group count; then
   ``tools.sweep_topk``'s sweeps of G at SSD512's and SSD300's shapes.
5. main path: seeded full-width SSD300-VGG16 serves uint8 300x300 batches
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
   tail, on the device alone and as launched, and the per-set top-k
   again by one flat stable sort a set.
6. families: every other detector of the zoo at its published widths,
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
7. train: seeded full-width SSD300-VGG16 takes train steps on the card
   (bfloat16, batch 32, the photometric distortion on the device, LR
   1e-5, seeded uint8 300x300 images with one GT box each): 3 warm-up
   steps, then 20 timed by CUDA events; images/s, ms/step, the split by
   stage (augment, forward, loss = match and mine, backward, optimizer),
   peak memory, and every step's loss finite with num_pos > 0. The NMS
   kernel must not launch in a train step.
8. train_parity: one float32 step (TF32 off, batch 2) on the card and the
   same step on the CPU, with the same weights, batch and injected
   augmentation parameters, and on the CPU in float64.
   The card takes the step with cuDNN and again with cuDNN off. The
   batch gives every head and extra layer a gradient, which the float64
   step must show. Each tensor's card update must lie within a relative
   L2 error of 1e-3 of the CPU's with cuDNN off, and of 5e-3 with cuDNN;
   the counts within 1e-3, the ReLU sign flips between the forwards and
   the losses are printed.
9. family_train: every configuration of the families phase trains at
   full width from ``create_train_state``'s init, as ``train`` does for
   SSD300 (bf16, batch 32, 3 warm-up and 10 timed steps): ms/step,
   images/s, the split by stage, peak memory; every loss finite with
   num_pos > 0, every batch norm's running statistics finite and moved,
   no NMS launch. Each model is freed before the next.
10. family_train_parity: ``train_parity`` for RFBNet300 (batch norm) and
   RefineDet320 (its two-step loss, the ARM heads moved off their init
   so that the refined anchors, their clamp and the negative-anchor
   filter take part): one step on the card with and without cuDNN
   against the CPU's, in float64 and in float32. In float64 every
   update and running statistic must lie within the same limits; in
   float32 the losses, positives, ignored anchors and running statistics
   must, and the updates are printed beside the ReLU sign flips that
   put them off (see :func:`family_train_parity`).
11. fit: ``odtpu_torch.train.fit`` on a seeded VOC tree written to a
   temporary directory under ``build/`` (PPM images at the network's
   size, read by ``data.image.imread``, XML and ImageSets), through the
   pass-through transform: a first run from a
   ``--basenet`` npz saves and validates, a second auto-resumes from its
   checkpoint, saves and validates again. Each validation scores VOC mAP
   through the serving path, so ``nms_rows`` must launch once per eval
   batch. Then the same two runs of RFBNet300: each validation must
   leave its running statistics bit-equal, and a restore of the first
   run's checkpoint must give them back bit-equal.
12. data: the host pipeline on the card's host, with no OpenCV: a seeded
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
13. cli: the two command lines at full width on such a tree (1024 + 64
   images): ``odtpu_torch.train``'s ``setup`` and ``run`` train SSD300
   (bf16, batch 32, the float host path, 8 workers) for 20 steps, inside
   one epoch, from a
   ``--basenet`` npz, save at 10 and 20, validate at 20, and trace steps
   11-20 with ``--profile_dir`` (the trace must exist; its kernel events
   give the card's busy share of the window); then ``odtpu_torch.eval``'s
   ``setup`` and ``run`` score the last checkpoint (``--ckpt``): its mAP
   and its detection files must equal the train run's last validation.
   ``nms_rows`` must launch once per eval batch in each, ``nms_mask``
   never. ``python -m odtpu_torch.serve --ckpt`` serves that checkpoint
   in a subprocess: 2 posted images answered as a ``Detector`` built
   from it answers. Last, ``python -m odtpu_torch.train`` in a
   subprocess, 4 steps with a save every 2, under ``--max_rss_gb 0.01``:
   one re-exec, at step 2, then the run resumes and ends at step 4; its
   checkpoints equal, bit for bit, those of the same run without the
   flag stopped at step 2 and resumed with ``--resume``.
14. coco: a seeded COCO tree (``instances_minival2014.json``, 64 PPM
   images at 640x480 and 480x640, the 80 category ids): the eval command
   line on ``ssd_vgg16_coco`` with the seeded served weights as an npz
   (``--model_npz``) gives mAP@0.5 and mAP@[.5:.95] in [0, 1] with one
   ``nms_rows`` launch per batch; ``EvalCOCO`` fed the ground truth as
   its rows scores 1.0 and 1.0.
15. int8: seeded SSD300 and every configuration of ``families`` served
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
16. serve: ``odtpu_torch.serve`` on 127.0.0.1 (a free port) in a thread,
   in bfloat16 and in int8: ``/healthz``, then 20 ``POST /detect`` of
   seeded PPM images at VOC's sizes (500x375, 375x500); every response
   carries detections and equals ``build_engine``'s ``infer`` called
   directly on the same bytes; one 404 and one 400. p50 and p90 of the
   request's wall time and of ``latency_ms``; one ``nms_rows`` launch
   per request.
17. export: seeded full-width SSD300 exported by ``odtpu_torch.export``
   (``torch.export`` through the registered op ``odtpu::nms_rows``) at
   batch 32 in bfloat16 and in int8 convs, and for any batch in
   bfloat16, under ``build/``; one fresh subprocess that imports only
   what ``load_artifact`` needs (no model, config or data module) loads
   and serves each, 3 warm-up and 10 timed calls: its rows equal the
   live ``Detector``'s on the same batch exactly (the polymorphic
   artifact's at B=1 and B=32), one ``nms_rows`` launch a call; ms per
   batch beside the live path's, export and load seconds, the
   artifact's bytes.
18. extras: bf16 SSD300 steps at batch 32 with ``LOSS.REPULSION_WEIGHT =
   0.5`` on :func:`parity_batch`'s several boxes an image
   (``loss_repul`` finite and > 0, the repelled priors counted); SSD300
   and RFBNet300 with ``TPU.REMAT`` off and on, 3 warm-up and 10 timed
   steps each: ms/step and peak memory; and one float32 step of each
   from the same state with and without remat (cuDNN deterministic):
   every update and running statistic within 1e-5 relative L2, the
   statistics moved once.
19. ddp: data parallelism, one process a rank, each launched by
   ``python -m torch.distributed.run`` running this script as a child
   (``--ddp_child``, through the train command line's ``distributed``,
   ``setup`` and ``run``), on a seeded VOC tree (320 + 128 images).
   Two ranks on gloo, both on cuda:0 (NCCL refuses two ranks on one
   card), each take one step of SSD300 in float32 (TF32 and cuDNN off)
   and of RFBNet300 in float64 on their 2 of 4 images; each is held to
   the one-process step on the 4 (:data:`DDP_LIMITS`: 1e-3 and 1e-9
   relative L2 a tensor, running statistics too), the ranks bit-equal.
   Then the same two processes run RFBNet300 ``--multihost``, 4 bf16
   steps of 16 images a rank and one validation of each rank's 64 test
   images: one ``nms_rows`` launch an eval batch and one ``bn_eval`` a
   norm an eval batch on each rank, the same losses and mAP on both.
   Last, one process trains SSD300 at batch 32 in bf16 (the uint8 path)
   for 10 steps and one validation, without ``--multihost`` and then
   with it at world 1 on NCCL (cuDNN deterministic): equal losses and
   mAP, ms a step of both, and the all-reduce of SSD300's float32
   gradients in ms.
20. visualize: (a) the eval-mode norm's backward with respect to x, the
   entry ``bn_eval_backward_dx`` of ``csrc/batch_norm.cu``, against
   ``bn_eval_backward_plain`` on RFBNet512's and RFBNet300's largest norm
   inputs (bf16 channels-last), float32 and float64 cases: bit for bit,
   two launches bit-equal; timed on the first beside the plain version,
   autograd's backward of ``F.batch_norm`` with respect to x and the
   bound. (b) ``train_debug.run`` on RFBNet300 at full width (bf16,
   seeded, a VOC tree of 288 + 32 PPM images) with
   ``LOG.SHOW_SALIENCY``: one step with a finite loss, six non-constant
   uint8 saliency images, ``bn_eval`` once a norm for the saliency's
   forward and each eval batch, the dx entry once for every norm
   upstream of each source (counted in the autograd graph), no parameter
   gradient, ``nms_rows`` once an eval batch; the same weights' input
   gradients: float64 within 1e-9 relative L2 of the CPU's per source,
   float32 (TF32 off) through the kernel bit-equal to the card's own
   plain path (cuDNN deterministic), and, printed with the ReLU sign
   flips between the two forwards, float32 against the CPU's with cuDNN
   on and off and the CPU's against the CPU's without oneDNN, as for the
   seeded served weights on the same image and on noise; traced: each
   ReLU's sign flips and each max pool's argmax changes between the
   card's float32 forward and the CPU's, and the card's float32
   gradients with the CPU's choices forced, against the CPU's.
   (c) ``train.setup``/``train.run`` of RFBNet300 at batch 32, 8 steps
   and one validation, with ``SHOW_AUG_STEPS``, ``SHOW_ANCHOR_MAPS``,
   ``SHOW_TEST_IMAGE`` and ``SHOW_PR_CURVE`` off and then on, into a
   recording writer: at most 8 items dumped at every stage, one anchor
   map a (source, slot), 4 ``eval/detections`` images whose red GT
   outlines lie where the batch's boxes are, one PR curve a class with
   detections, the run archived under a ``HISTORY_ROOT`` in ``build/``;
   ms a step both ways. (d) the demos on SSD300: ``detect_img``'s rows
   equal ``Detector``'s, its PPM changed only in green; ``live
   --headless`` over 20 PPM frames, one ``nms_rows`` launch a frame,
   frame 0's rows equal ``detect_img``'s, the FPS.
21. mesh: tensor-parallel and spatial meshes, one process a
   rank on gloo, every rank on cuda:0, launched by ``python -m
   torch.distributed.run`` running this script (``--mesh_child DxMxS
   WORK``), cuDNN deterministic, on a seeded VOC tree (64 + 32 images):
   at (D, M, S) = (1, 2, 1), (1, 1, 2) and (1, 2, 2) one step of
   full-width SSD300 (batch 2) in float32 (TF32 and cuDNN off) and in
   float64, at (1, 2, 2) RFBNet300 in float64, each held to one process
   (relative L2 a tensor, gathered): float64 to its step within 1e-9,
   float32 within 1e-6 to its step run with the layout's conv shapes
   (channel blocks, slabs with halos cut from the whole map), whose
   distance from the plain step and from float64's is printed with the
   ReLU signs 2 blocks flip; at (1, 2, 1) and (1, 1, 2) an eval
   batch of 4 images of every ``families`` configuration in float32, its
   norms drawn at random: the gathered loc and conf within 1e-5 of one
   process's, the rows at rtol 1e-4 and atol 1e-5 but where traced to a
   tie in scores, equal to the plain detect path's, one ``nms_rows`` a
   rank; the command lines (``train.parse_args``, ``setup``, ``run`` in
   the gloo group): ``--multihost --mesh_model 2`` trains SSD300 for 4
   bf16 steps of 32 images and validates, and ``odtpu_torch.eval
   --multihost --mesh_spatial 2`` and ``odtpu_torch.eval`` at world 1
   score its checkpoint in float32, their detection files equal but at
   ties; per rank the parameter and momentum bytes at M = 2 (at most
   0.65 of world 1's), the step's peak memory, activations and bytes
   saved for the backward (its halo copies apart) at S = 2, the halo
   bytes and ms a step (gloo sharing one card: correctness and memory,
   not scaling).
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
import signal
import subprocess
import sys
import tempfile
import threading
import time
import weakref
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from odtpu_torch import eval_step, export, train, train_debug
from odtpu_torch import serve as http_serve
from odtpu_torch.data import augment, dataset_factory, native
from odtpu_torch.data.device_aug import draw_params
from odtpu_torch.data.image import imdecode, imread, write_ppm
from odtpu_torch.data.loader import DetLoader, NetworkInput
from odtpu_torch.data.voc import VOC_CLASSES, VOCDetection
from odtpu_torch.demo import detect_img, live
from odtpu_torch.eval import cli
from odtpu_torch.eval.evaluator import (EvalVOC, dense_to_rows,
                                        eval_solver_factory)
from odtpu_torch.infer import (Detector, power_limit, random_images,
                               random_state_dict)
from odtpu_torch.layers.losses import repulsion_loss
from odtpu_torch.models import model_factory, probe_layer_dims
from odtpu_torch.models.common import BatchNorm2d, Conv
from odtpu_torch.ops import detect, quant, topk
from odtpu_torch.ops.boxes import decode
from odtpu_torch.ops.cuda import batch_norm, build, nms_kernel
from odtpu_torch.ops.priors import PriorBoxSSD, prior_factory
from odtpu_torch.tools import get_flops, sweep_topk
from odtpu_torch.train import fit
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils import visualize
from odtpu_torch.utils.checkpoint import (Checkpointer, load_strict,
                                          to_odtpu_params)
from odtpu_torch.utils.config import default_cfg, load_cfg
from odtpu_torch.utils.logging import TBWriter

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


def captured(fn, calls=1):
    """A CUDA graph of ``calls`` calls of fn(), warmed up on a side
    stream first, and the last call's outputs, which each replay
    rewrites. ``fn`` launches on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return graph, out


def graph_ms(fn, iters):
    """Mean milliseconds of fn() on the device alone: ``iters`` calls
    captured in a CUDA graph and replayed, so the host's cost of each
    launch does not count."""
    graph, _ = captured(fn, iters)
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


# (label, rows, n) of the per-set top-k (k = 200) at B = 32 on each detect
# path: B * (C - 1) candidate sets over the priors, the cross-class
# compaction over C * 200 rows an image, survivors-first over the dense
# [B * C, 200] (flat: one group)
TOPK_SHAPES = (
    ("SSD300, FPN300, FSSD300, SSD300-DRN22/24", 640, 8732),
    ("SSD300-COCO", 2560, 8732), ("RFBNet300", 640, 11620),
    ("RefineDet320", 640, 6375), ("SSD512-VOC", 640, 24564),
    ("DRN_SSD", 640, 28158), ("RFBNet512", 640, 32756),
    ("_compact VOC", 32, 4000), ("_compact COCO", 32, 16000),
    ("survivors_first", 672, 200))
TOPK_KINDS = ("uniform", "ties", "equal")


def topk_scores(kind, rows, n, seed=0, device="cuda"):
    """Seeded float32 scores [rows, n]: uniform, tie-heavy (drawn from
    {0, 0.25, 0.5, 1}) or all equal."""
    g = torch.Generator().manual_seed(seed)
    if kind == "uniform":
        x = torch.rand(rows, n, generator=g)
    elif kind == "ties":
        x = torch.tensor([0.0, 0.25, 0.5, 1.0])[
            torch.randint(0, 4, (rows, n), generator=g)]
    else:
        x = torch.full((rows, n), 0.5)
    return x.to(device)


def grouped_equals_flat(x, k=200, replay=False):
    """Whether the grouped top-k (the default G) gives the flat stable
    sort's values and indices on ``x``, bit for bit; ``replay``: the
    grouped one replayed from a CUDA graph."""
    def grouped():
        return topk.top_k_exact(x, k)

    got = grouped()
    if replay:
        graph, got = captured(grouped)
        for t in got:
            t.zero_()
        graph.replay()
    want = topk.top_k_exact(x, k, groups=0)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def phase_topk(k=200, iters=20):
    """``ops.topk.top_k_exact``, the two-level split, at every shape of
    :data:`TOPK_SHAPES`: values and indices bit-equal to the flat stable
    sort on uniform, tie-heavy and all-equal scores, called and replayed
    from a CUDA graph; the device's ms
    (``device_ms``: replayed from a CUDA graph) and the ms as launched,
    grouped and flat, on the uniform scores; then
    ``tools.sweep_topk``'s sweeps at SSD512's and SSD300's shapes."""
    if os.environ.get("ODTPU_TOPK_GROUPS") is not None:
        raise AssertionError("ODTPU_TOPK_GROUPS is set: the phase times "
                             "the default group counts")
    shapes = []
    for label, rows, n in TOPK_SHAPES:
        for kind in TOPK_KINDS:
            x = topk_scores(kind, rows, n)
            for replay in (False, True):
                if not grouped_equals_flat(x, k, replay):
                    raise AssertionError(
                        "top-k at {} [{}, {}], {} scores{}: grouped != "
                        "flat".format(label, rows, n, kind, " replayed from "
                                      "a CUDA graph" if replay else ""))
        x = topk_scores("uniform", rows, n)
        one = {"shape": label, "rows": rows, "n": n,
               "groups": topk.num_groups(n, k), "exact": list(TOPK_KINDS)}
        for mode, groups in (("grouped", None), ("flat", 0)):
            def fn(groups=groups):
                return topk.top_k_exact(x, k, groups=groups)
            fn()
            one[mode + "_device_ms"] = graph_ms(fn, iters)
            one[mode + "_ms"] = cuda_ms(fn, iters)
        shapes.append(one)
        del x
    sweeps = [sweep_topk.sweep(640, n, k, device="cuda")
              for n in (24564, 8732)]
    torch.cuda.empty_cache()
    result = {"phase": "topk", "k": k, "shapes": shapes,
              "sweeps": [{**s, "ms": {str(g): ms for g, ms in s["ms"].items()}}
                         for s in sweeps],
              "nvidia_smi": power_limit()}
    emit(result)
    for s in sweeps:
        print("sweep_topk [{}, {}] k {} (default G {}): {}".format(
            s["rows"], s["n"], k, s["chosen"], ", ".join(
                "{} {:.4f} ms".format("flat" if g == 0 else "G=%d" % g, ms)
                for g, ms in s["ms"].items())), flush=True)
    return result


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
    reset_norm_counts()


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
    replayed from a CUDA graph) and as launched from Python; and both
    times of ``top_k_per_set`` (the two-level split) done by one flat
    stable sort a set instead."""
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

    def flat():  # the per-set select by one flat stable sort a set
        return topk.top_k_exact(conf_fg.transpose(1, 2).contiguous().view(
            -1, conf_fg.shape[1]), top_k, groups=0)

    with torch.inference_mode():
        for name, fn in stages.items():
            device[name] = graph_ms(fn, iters)
            launched[name] = cuda_ms(fn, iters)
        flat_ms = {"device_ms": graph_ms(flat, iters),
                   "ms": cuda_ms(flat, iters)}
    return device, launched, flat_ms


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


def eval_dense(det, images, batches=5):
    """The eval step's dense contract (``EVAL.COMPACT = False``) on the
    served batch, ``batches`` times with the counts reset just before and
    read just after: one ``nms_rows`` launch a batch and no ``nms_mask``;
    its dense result as rows (``dense_to_rows``) holds every row of the
    compact path's, and as many more survivors as the compact path
    reports ``dropped``; ms a batch beside the compact path's."""
    step = eval_step.make_eval_step(det.model, det.step.priors, det.cfg,
                                    compact=False)
    det(images)
    step(images)
    reset_counts()
    for _ in range(batches):
        dense = step(images)
    torch.cuda.synchronize()
    launches = counts()
    if launches != {"nms_mask": 0, "nms_rows": batches}:
        raise AssertionError("{} dense eval batches made NMS launches {}; "
                             "want one nms_rows a batch".format(batches,
                                                                launches))
    compact = det(images)
    rows = compact["rows"].cpu().numpy()
    every = dense_to_rows(dense.cpu().numpy())
    missing, extra = 0, 0
    for b in range(rows.shape[0]):
        kept = {tuple(r) for r in rows[b][rows[b][:, 0] > 0]}
        survivors = {tuple(r) for r in every[b][every[b][:, 0] > 0]}
        missing += len(kept - survivors)
        extra += len(survivors) - len(kept)
    dropped = int(compact["dropped"].sum())
    if missing or extra != dropped:
        raise AssertionError("dense contract: {} compact rows missing, {} "
                             "more survivors against {} dropped".format(
                                 missing, extra, dropped))
    return {"batch": int(images.shape[0]), "shape": list(dense.shape),
            "launches": launches, "rows_missing": missing,
            "survivors": int((every[..., 0] > 0).sum()),
            "compact_rows": int((rows[..., 0] > 0).sum()),
            "dropped": dropped,
            "ms": cuda_ms(lambda: step(images), 5),
            "compact_ms": cuda_ms(lambda: det(images), 5)}


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
        result["eval_dense"] = eval_dense(det, images)
        device, launched, flat = detect_split(step, loc, conf)
        emit({"phase": "detect_split", "dtype": dtype, "batch": BATCH,
              "device_ms": device, "device_sum_ms": sum(device.values()),
              "launched_ms": launched,
              "launched_sum_ms": sum(launched.values()),
              "top_k_groups": topk.num_groups(loc.shape[1], step.top_k),
              "top_k_per_set_flat": flat,
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
    """Forward FLOPs of one image through ``cfg``'s convs:
    2 x kh x kw x Cin x Cout x Hout x Wout per conv (get_flops.py's
    multiply-adds, doubled; biases, norms and upsampling left out), from
    ``tools.get_flops.conv_shapes``'s forward on the ``meta`` device."""
    return sum(2 * kh * kw * cin * cout * oh * ow
               for _, (kh, kw, cin, cout), (oh, ow), _ in
               get_flops.conv_shapes(cfg))


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

    def validate(self, eval_fn, tb_writer=None):
        model = eval_fn.model
        before, mode = running_stats(model), model.training
        out = self.solver.validate(eval_fn, tb_writer)
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
        cfg.GENERAL.HISTORY_ROOT = os.path.join(work, "history")
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
        served = serve_checkpoint(os.path.join(out, "ckpt"), work)
        rss = rss_reexec(work, basenet)
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
                  "trace": busy, "serve_ckpt": served, "max_rss_gb": rss,
                  "nvidia_smi": power_limit()}
        emit(result)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_checkpoint(ckpt, work, conf=CONF, requests=2, timeout=300):
    """``python -m odtpu_torch.serve --ckpt <ckpt>`` (the train command
    line's checkpoint directory) on a free port of 127.0.0.1: ``requests``
    PPM images at VOC's sizes posted; each answer must equal
    ``serve.detections`` of the rows of a ``Detector`` built here from
    that checkpoint's latest state dict, on the same image."""
    log = os.path.join(work, "serve_ckpt.log")
    handle = start([sys.executable, "-m", "odtpu_torch.serve", "--ckpt",
                    ckpt, "--port", "0", "--conf", str(conf)], log)
    images = [random_images(1, VOC_SIZES[i % 2], 200 + i)[0]
              for i in range(requests)]
    try:
        port = None
        while port is None:
            with open(log) as f:
                found = re.search(r"^serving .* on :(\d+)", f.read(), re.M)
            if found:
                port = int(found.group(1))
            elif handle[0].poll() is not None \
                    or time.perf_counter() - handle[3] > timeout:
                stop(handle)
                with open(log) as f:
                    raise AssertionError("serve --ckpt did not start:\n"
                                         + f.read()[-4000:])
            else:
                time.sleep(0.5)
        start_s = time.perf_counter() - handle[3]
        answers = [post("http://127.0.0.1:{}/detect".format(port),
                        b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0])
                        + np.ascontiguousarray(img[:, :, ::-1]).tobytes())
                   for img in images]
    finally:
        stop(handle)
    det = Detector(load_cfg("ssd_vgg16_voc"),
                   state_dict=Checkpointer(ckpt).read()["model"])
    for i, (img, (status, got, _)) in enumerate(zip(images, answers)):
        rows = det(augment.resize_u8(img, (300, 300))[None])["rows"]
        want = http_serve.detections(rows[0].cpu().numpy(), img.shape[:2],
                                     list(VOC_CLASSES), conf)
        if status != 200 or got.get("detections") != want:
            raise AssertionError("serve --ckpt, request {}: {} {} against "
                                 "the Detector's {}".format(
                                     i, status, str(got)[:300],
                                     str(want)[:300]))
    del det
    torch.cuda.empty_cache()
    return {"requests": requests, "start_seconds": start_s,
            "detections": [len(a[1]["detections"]) for a in answers],
            "equal_to_detector": True}


# the --max_rss_gb runs of the cli phase: SSD300 on its tree, a save
# every 2 steps, no validation before the last step
RSS_YML = """\
# SSD300, 4 steps, a save every 2 (chip_smoke.py cli, --max_rss_gb)
GENERAL:
  HISTORY_ROOT: '{work}/history'
DATASET:
  DATASET_DIR: '{work}/voc'
  TRAIN_SETS: (('2007', 'trainval'),)
TRAIN:
  SAVE_ITER: 2
  EVAL_ITER: 1000
  LOG_LOSS_ITER: 1
  OPTIMIZER:
    LR: 1.0e-5
"""


def same_checkpoints(a, b):
    """Whether two checkpoint files hold the same step, model and
    optimizer state, bit for bit."""
    a, b = (torch.load(p, map_location="cpu", weights_only=True)
            for p in (a, b))

    def same(x, y):
        if isinstance(x, dict):
            return (isinstance(y, dict) and x.keys() == y.keys()
                    and all(same(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and same_bits(x, y)
        return x == y

    return same(a, b)


def rss_reexec(work, basenet, steps=4, timeout=600):
    """``python -m odtpu_torch.train`` in a subprocess, ``steps`` steps
    with a save every 2, under ``--max_rss_gb 0.01``: it must re-exec
    itself once, at step 2 (``odtpu``'s line printed once), resume there
    and finish at ``steps``. Its checkpoints must equal, bit for bit,
    those of the same run without the flag (``--max_rss_gb 0``) stopped
    at step 2 and resumed by hand with ``--resume`` (the arguments of
    ``train._resume_argv``): a resume restarts the loader's epoch, as
    ``odtpu``'s does, so a run never stopped sees other batches after
    step 2."""
    yml = os.path.join(work, "rss.yml")
    with open(yml, "w") as f:
        f.write(RSS_YML.format(work=work))

    def command(out, *extra):
        return [sys.executable, "-m", "odtpu_torch.train", "--cfg", yml,
                "--cfg_name", "rss", "--output_dir", os.path.join(work, out),
                "--basenet", basenet, *extra]

    # the two runs side by side on the card, each in its own processes
    on = start(command("rss_on", "--max_iter", str(steps), "--max_rss_gb",
                       "0.01"), os.path.join(work, "rss_on.log"))
    off = command("rss_off", "--max_rss_gb", "0")
    try:
        first = start(off + ["--max_iter", "2"],
                      os.path.join(work, "rss_off_1.log"))
        seconds = {"off_to_2": finish(first, timeout)}
        resumed = train._resume_argv(off + ["--max_iter", str(steps)],
                                     os.path.join(work, "rss_off", "ckpt"))
        seconds["off_resumed"] = finish(start(resumed, os.path.join(
            work, "rss_off_2.log")), timeout)
        seconds["on"] = finish(on, timeout)
    finally:
        stop(on)
    with open(os.path.join(work, "rss_on.log")) as f:
        log = f.read()
    lines = re.findall(r"^RSS .* re-exec with --resume at iter (\d+)$", log,
                       re.M)
    if lines != ["2"] or "resumed at step 2" not in log \
            or "done at iter {}".format(steps) not in log:
        raise AssertionError("--max_rss_gb run: re-execs at {}, log:\n{}"
                             .format(lines, log[-3000:]))
    equal = {}
    for step in (2, steps):
        paths = [os.path.join(work, run, "ckpt", "{}.pt".format(step))
                 for run in ("rss_on", "rss_off")]
        equal[step] = same_checkpoints(*paths)
    if not all(equal.values()):
        raise AssertionError("--max_rss_gb run's checkpoints against the "
                             "run without it: equal {}".format(equal))
    return {"steps": steps, "reexec_at": [int(v) for v in lines],
            "rss_line": re.search(r"^RSS .*$", log, re.M).group(0),
            "checkpoints_equal": {str(k): v for k, v in equal.items()},
            "seconds": seconds}


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


# --- visualize: the norm's backward, saliency, the LOG.SHOW_* images, the
# demos (odtpu_torch.train_debug, utils.visualize, demo) ---

class Recorder:
    """What a ``SummaryWriter`` would be handed, for ``TBWriter.writer``:
    the card's machine has no tensorboard (the tests use it too)."""

    def __init__(self):
        self.images, self.histograms, self.curves = [], [], []

    def add_image(self, tag, img, step, dataformats="HWC"):
        assert dataformats == "HWC"
        self.images.append((tag, np.array(img), int(step)))

    def add_histogram(self, tag, values, step):
        self.histograms.append((tag, np.array(values), int(step)))

    def add_pr_curve_raw(self, tag, **kw):
        self.curves.append((tag, kw))

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass

    def tags(self):
        return [t for t, _, _ in self.images]


def recording_writer(writer_cls=TBWriter):
    """A ``writer_cls`` (the port's ``TBWriter``, or one of the same
    shape) writing to a :class:`Recorder`."""
    tb = writer_cls("")
    tb.writer = Recorder()
    return tb


def reset_norm_counts():
    batch_norm.LAUNCHES = batch_norm.DX_LAUNCHES = 0


def norm_counts():
    return {"bn_eval": batch_norm.LAUNCHES,
            "bn_eval_backward_dx": batch_norm.DX_LAUNCHES}


# the backward's cases: each family's largest norm inputs in the serving
# layout (bf16, channels-last), float32 NCHW-contiguous (with H*W a
# multiple of 8 and not), float64 both ways; the first is timed
BN_BACKWARD_CASES = (
    ("rfbnet512", (32, 512, 64, 64), torch.bfloat16, True),
    ("rfbnet300", (32, 512, 38, 38), torch.bfloat16, True),
    ("rfbnet300", (32, 512, 38, 38), torch.float32, False),
    ("rfbnet512", (32, 512, 64, 64), torch.float32, False),
    ("float64", (8, 256, 19, 19), torch.float64, False),
    ("float64", (8, 256, 19, 19), torch.float64, True))


def bn_backward_inputs(shape, dtype, channels_last, seed=0):
    """Seeded dy (in ``dtype`` and the layout) and mul."""
    g = torch.Generator().manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    dy = torch.randn(*shape, generator=g).to(dtype).cuda().contiguous(
        memory_format=fmt)
    mul = (torch.rand(shape[1], generator=g) + 0.5).to(
        batch_norm.wide_dtype(dtype)).cuda()
    return dy, mul


def entry_bound(nbytes, ops):
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_F32_FLOP_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def check_bn_backward(label, shape, dtype, channels_last, timed=False,
                      iters=20):
    """The backward's dx entry against ``bn_eval_backward_plain`` on
    seeded inputs: bit for bit, a second launch bit-equal. ``timed``: its
    ms (launched from Python), device_ms (a CUDA graph), its plain
    version's, autograd's backward of ``F.batch_norm(training=False)``
    with respect to x alone, and its bound."""
    dy, mul = bn_backward_inputs(shape, dtype, channels_last)
    dx = batch_norm.bn_eval_backward_dx_cuda(dy, mul)
    dx2 = batch_norm.bn_eval_backward_dx_cuda(dy, mul)
    want = batch_norm.bn_eval_backward_plain(dy, mul)
    torch.cuda.synchronize()
    case = "{} {} {} {}".format(label, list(shape), str(dtype)[6:],
                                "channels-last" if channels_last
                                else "contiguous")
    if not (same_bits(dx, want) and dx.stride() == want.stride()):
        raise AssertionError("bn backward dx != plain on {}: {} of {} "
                             "differ".format(case, int((dx != want).sum()),
                                             dx.numel()))
    if not same_bits(dx, dx2):
        raise AssertionError("bn backward: two launches differ on " + case)
    out = {"case": case, "dx_exact": True, "deterministic": True}
    if not timed:
        return out
    n, c = dy.numel(), shape[1]

    def dx_call():
        return batch_norm.bn_eval_backward_dx_cuda(dy, mul)

    # cuDNN's (or ATen's) eval-mode norm backward on the same input, with
    # respect to x alone
    xr = torch.zeros_like(dy).requires_grad_()
    ones = torch.ones(c, device=dy.device)
    y = F.batch_norm(xr, torch.zeros_like(ones), ones, ones, ones * 0,
                     False, 0.0, 1e-5)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        y, xr, dy, retain_graph=True), iters)
    out.update({"ms": cuda_ms(dx_call, iters),
                "device_ms": graph_ms(dx_call, iters),
                "plain_ms": cuda_ms(lambda: batch_norm.bn_eval_backward_plain(
                    dy, mul), iters),
                "library_ms": library_ms, "max_abs_err": 0.0,
                **entry_bound(2 * n * dy.element_size()
                              + c * mul.element_size(), n)})
    return out


def bn_nodes_upstream(t):
    """``BnEvalFn`` backward nodes in the autograd graph of ``t``: the
    eval-mode norms that its backward runs."""
    seen, stack, n = set(), [t.grad_fn], 0
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += "BnEvalFn" in f.name()
        stack.extend(nf for nf, _ in f.next_functions)
    return n


def saliency_norms(model, image):
    """The norms upstream of each source of ``model``'s eval-mode forward
    on ``image`` (NHWC float32 on the card)."""
    with train_debug.input_gradient_mode(model):
        x = image.detach().clone().requires_grad_()
        return [bn_nodes_upstream(s)
                for s in train_debug.source_fn(model)(x)]


@contextlib.contextmanager
def forward_choices(record=None, force=None):
    """Inside, every ``F.relu`` and ``F.max_pool2d`` call, in call order:
    with ``record`` (``{"relu": [], "pool": []}``), appends its own
    choice there, on the CPU (a ReLU's mask of positive inputs; a max
    pool's argmax indices, flat over each input plane, and its mask of
    positive maxima); with ``force`` (such a record of another forward),
    takes that forward's choice in place of its own: a ReLU passes its
    input where the forced mask is set and gives 0 elsewhere, a max pool
    gathers its input at the forced indices. Both in the forward and in
    its backward."""
    relu, pool = F.relu, F.max_pool2d
    seen = {"relu": 0, "pool": 0}

    def forced(kind):
        i = seen[kind]
        seen[kind] += 1
        return None if force is None else force[kind][i]

    def choose_relu(x, inplace=False):
        mask = x > 0
        if record is not None:
            record["relu"].append(mask.cpu())
        f = forced("relu")
        return relu(x, inplace) if f is None else x * f.to(x.device, x.dtype)

    def choose_pool(x, kernel_size, stride=None, padding=0, dilation=1,
                    ceil_mode=False, return_indices=False):
        out, idx = pool(x, kernel_size, stride, padding, dilation,
                        ceil_mode=ceil_mode, return_indices=True)
        if record is not None:
            record["pool"].append((idx.cpu(), (out > 0).cpu()))
        f = forced("pool")
        if f is not None:
            out = x.flatten(2).gather(2, f[0].to(x.device).flatten(2)).view(
                out.shape)
        return (out, idx) if return_indices else out

    F.relu, F.max_pool2d = choose_relu, choose_pool
    try:
        yield
    finally:
        F.relu, F.max_pool2d = relu, pool
    if force is not None and (seen["relu"] != len(force["relu"])
                              or seen["pool"] != len(force["pool"])):
        raise AssertionError("forced {} ReLUs and {} pools of a forward "
                             "with {} and {}".format(
                                 seen["relu"], seen["pool"],
                                 len(force["relu"]), len(force["pool"])))


def choices_apart(a, b):
    """Per call, between two :func:`forward_choices` records of the same
    forward: the ReLU outputs whose sign differs, and the max-pool windows
    whose argmax differs (all, and those where a maximum is positive:
    elsewhere the gradient dies at the ReLU before the pool)."""
    if len(a["relu"]) != len(b["relu"]) or len(a["pool"]) != len(b["pool"]):
        raise AssertionError("the two forwards made other calls")
    relu = [int((x != y).sum()) for x, y in zip(a["relu"], b["relu"])]
    pool = [(int((ia != ib).sum()), int(((ia != ib) & (pa | pb)).sum()))
            for (ia, pa), (ib, pb) in zip(a["pool"], b["pool"])]
    return {"relu_calls": len(relu), "relu_flips": sum(relu),
            "relu_flips_by_call": {i: n for i, n in enumerate(relu) if n},
            "relu_outputs": sum(m.numel() for m in a["relu"]),
            "pool_calls": len(pool),
            "pool_argmax_apart": [n for n, _ in pool],
            "pool_argmax_apart_positive": [n for _, n in pool],
            "pool_windows": [ia.numel() for ia, _ in a["pool"]]}


def saliency_run(dtype, weights, image, device, plain_dx=False,
                 cudnn=True, deterministic=False, mkldnn=True, record=None,
                 force=None):
    """RFBNet300's six raw input gradients on ``device`` in ``dtype``
    (float32: TF32 off) from ``weights`` on ``image``, and the Conv ReLU
    masks of its forward. ``plain_dx``: each norm's backward on the card
    by ``bn_eval_backward_plain`` in place of the kernel's dx entry;
    ``cudnn``: off runs the convs by ATen's own CUDA code;
    ``deterministic``: cuDNN's deterministic algorithms only; ``mkldnn``:
    off runs the CPU's float32 convs by ATen's own code; ``record`` and
    ``force``: the forward's ReLU and max-pool choices recorded, or
    another forward's taken (:func:`forward_choices`)."""
    cfg = load_cfg("rfbnet300_vgg16_voc")
    cfg.TPU.COMPUTE_DTYPE = dtype
    model, _, _ = model_factory("eval", cfg, device)
    load_strict(model, weights)
    if dtype == "float64":
        model.double()
    if device == "cuda":
        model = model.to(memory_format=torch.channels_last)
    masks = relu_masks(model)
    kernel_dx = batch_norm.bn_eval_backward_dx
    if plain_dx:
        batch_norm.bn_eval_backward_dx = batch_norm.bn_eval_backward_plain
    try:
        with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                        deterministic=deterministic,
                                        allow_tf32=False), \
                torch.backends.mkldnn.flags(enabled=mkldnn), \
                forward_choices(record, force):
            grads = train_debug.saliency(model, image.astype(dtype), cfg,
                                         recording_writer())
    finally:
        batch_norm.bn_eval_backward_dx = kernel_dx
    return grads, masks


def grads_apart(a, b):
    """Relative L2 per source between two :func:`saliency_run` results,
    and the Conv ReLU outputs whose sign differs between their
    forwards."""
    return {"rel_l2": [rel_l2(torch.from_numpy(x), torch.from_numpy(y))
                       for x, y in zip(a[0], b[0])],
            "relu_flips": relu_flips(a[1], b[1])}


def saliency_parity(weights, image, tol=1e-9):
    """RFBNet300's input gradients from the debug run's ``weights`` on its
    ``image``: the card's float64 ones within ``tol`` of the CPU's; the
    card's float32 ones through the kernel bit-equal to the card's own
    plain path (cuDNN's deterministic algorithms in both: only the norms'
    backward differs, and its dx is bit-equal); printed: the card's
    float32 ones against the CPU's with cuDNN on and off, and the CPU's
    against the CPU's without oneDNN (mkldnn), as for the seeded served
    weights (``infer.random_state_dict``) on the same image and on
    seeded noise; and, traced, the ReLU signs and max-pool argmaxes of
    the card's float32 forward that differ from the CPU's, call by call
    (:func:`choices_apart`), and the card's float32 gradients with the
    CPU's choices forced (:func:`forward_choices`) against the CPU's.
    On images with flat boxes any two float32 conv implementations, the
    CPU's two among them, order the near-equal values of many max-pool
    windows otherwise and send their gradient elsewhere; float64 orders
    them alike."""
    out = {"float64": grads_apart(saliency_run("float64", weights, image,
                                               "cuda"),
                                  saliency_run("float64", weights, image,
                                               "cpu"))}
    out["float32_kernel_vs_plain_on_card"] = grads_apart(*(
        saliency_run("float32", weights, image, "cuda", plain_dx=plain,
                     deterministic=True) for plain in (False, True)))
    served = random_state_dict(load_cfg("rfbnet300_vgg16_voc"))
    noise = np.random.RandomState(3).uniform(
        -100, 100, image.shape).astype(np.float32)
    # the float32 gap traced on the debug run's weights and image: which
    # ReLU signs and max-pool argmaxes the card's forward (cuDNN on)
    # chooses otherwise than the CPU's, and the card's gradients with the
    # CPU's choices forced
    chosen = {"cpu": {"relu": [], "pool": []},
              "cuda": {"relu": [], "pool": []}}
    for label, w, img in (("", weights, image),
                          ("_served_weights", served, image),
                          ("_served_weights_noise_image", served, noise)):
        cpu = saliency_run("float32", w, img, "cpu",
                           record=None if label else chosen["cpu"])
        for cudnn in (True, False):
            out["float32{}{}".format(label, "" if cudnn else "_cudnn_off")] \
                = grads_apart(saliency_run(
                    "float32", w, img, "cuda", cudnn=cudnn,
                    record=None if label or not cudnn else chosen["cuda"]),
                    cpu)
        out["float32{}_cpu_vs_cpu_without_mkldnn".format(label)] = \
            grads_apart(cpu, saliency_run("float32", w, img, "cpu",
                                          mkldnn=False))
        if not label:
            out["float32_choices_card_vs_cpu"] = choices_apart(
                chosen["cuda"], chosen["cpu"])
            out["float32_card_with_cpu_choices_vs_cpu"] = grads_apart(
                saliency_run("float32", w, img, "cuda",
                             force=chosen["cpu"]), cpu)
            del chosen
    errs = out["float64"]["rel_l2"]
    if len(errs) != 6 or not max(errs) <= tol:
        raise AssertionError("saliency float64 card vs CPU: relative L2 {} "
                             "> {}".format(errs, tol))
    errs = out["float32_kernel_vs_plain_on_card"]["rel_l2"]
    if len(errs) != 6 or any(errs):
        raise AssertionError("saliency float32 on the card, kernel vs plain "
                             "dx: relative L2 {}, not bit-equal".format(errs))
    return out


def visualize_debug(root, work):
    """``train_debug.run`` on RFBNet300 (bf16, full width, seeded) with
    ``LOG.SHOW_SALIENCY``: one step, six saliency images through the
    backward entries, one eval pass through ``nms_rows``; the counts
    against the norms each source's backward reaches; then the gradients
    against the CPU's (:func:`saliency_parity`)."""
    cfg = load_cfg("rfbnet300_vgg16_voc")
    cfg.DATASET.DATASET_DIR = root
    cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
    cfg.DATASET.TEST_SETS = (("2007", "test"),)
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    cfg.LOG.SHOW_SALIENCY = True
    tb = recording_writer()
    reset_counts()
    t0 = time.perf_counter()
    out = train_debug.run(cfg, "cuda", os.path.join(work, "debug"),
                          tb_writer=tb)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**counts(), **norm_counts()}
    model = out["state"].model
    norms = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    eval_batches = -(-out["timing"]["images"]
                     // cfg.DATASET.EVAL_BATCH_SIZE)
    image = torch.from_numpy(out["image"]).cuda()
    per_source = saliency_norms(model, image)
    m = out["metrics"]
    images = tb.writer.images
    want = {"nms_mask": 0, "nms_rows": eval_batches,
            "bn_eval": norms * (1 + eval_batches),
            "bn_eval_backward_dx": sum(per_source)}
    if not (math.isfinite(m["loss"]) and m["num_pos"] > 0):
        raise AssertionError("train_debug step {}".format(m))
    if len(images) != 6 or len(per_source) != 6 or not all(
            img.dtype == np.uint8 and img.std() > 0 for _, img, _ in images):
        raise AssertionError("saliency images {}".format(
            [(t, img.dtype, float(img.std())) for t, img, _ in images]))
    if launches != want or min(per_source) < 1:
        raise AssertionError("train_debug launches {} against {} (norms "
                             "upstream of each source {})".format(
                                 launches, want, per_source))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_debug.saliency(model, out["image"], cfg, recording_writer())
    torch.cuda.synchronize()
    saliency_s = time.perf_counter() - t0
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del out, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"cfg": "rfbnet300_vgg16_voc", "dtype": "bfloat16",
            "batch": cfg.DATASET.TRAIN_BATCH_SIZE, "norms": norms,
            "loss": m["loss"], "num_pos": m["num_pos"],
            "saliency_images": len(images),
            "norms_upstream_of_each_source": per_source,
            "eval_batches": eval_batches, "launches": launches,
            "seconds": seconds, "saliency_seconds_warm": saliency_s,
            "grads_vs_cpu": saliency_parity(weights, image.cpu().numpy())}


SHOW_FLAGS = ("SHOW_AUG_STEPS", "SHOW_ANCHOR_MAPS", "SHOW_TEST_IMAGE",
              "SHOW_PR_CURVE")
AUG_STAGES = ("0_input", "1_photometric", "2_expand", "3_crop", "4_mirror",
              "5_resize")


def flags_run(root, work, steps, on):
    """``train.setup``/``train.run`` of RFBNet300 (bf16, batch 32) for
    ``steps`` steps and one validation, with :data:`SHOW_FLAGS` on or off,
    into a recording writer; (run, writer, launches, the validation's
    per-class results)."""
    args = train.parse_args(["--cfg_name", "rfbnet300_vgg16_voc",
                             "--output_dir", os.path.join(
                                 work, "flags_{}".format(on)),
                             "--max_iter", str(steps)])
    cfg, out_dir, log_dir = train.setup(args)
    cfg.DATASET.DATASET_DIR = root
    cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
    cfg.DATASET.TEST_SETS = (("2007", "test"),)
    cfg.GENERAL.HISTORY_ROOT = os.path.join(work, "history")
    cfg.TRAIN.SAVE_ITER = cfg.TRAIN.EVAL_ITER = steps
    cfg.TRAIN.LOG_LOSS_ITER = 1
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    for flag in SHOW_FLAGS:
        cfg.LOG[flag] = on
    tb = recording_writer()
    seen, real = [], EvalVOC.evaluate_stats

    def evaluate_stats(self, tb_writer=None):
        res = real(self, tb_writer)
        seen.append(res[0])
        return res

    EvalVOC.evaluate_stats = evaluate_stats
    reset_counts()
    try:
        res = train.run(args, cfg, out_dir, log_dir, tb_writer=tb)
    finally:
        EvalVOC.evaluate_stats = real
    torch.cuda.synchronize()
    return res, tb.writer, {**counts(), **norm_counts()}, seen, cfg


def red_gt_share(images, loader, size):
    """For the first eval batch's first images as ``eval/detections``
    logged them (RGB): the share of each GT box's thickness-2 outline
    that is red (GT) or green (a detection drawn over it); the lowest."""
    batches = iter(loader)
    batch = next(batches)
    batches.close()  # stops the loader's threads
    shares = []
    for b, (_, img, _) in enumerate(images):
        for box, label in zip(batch["boxes"][b], batch["labels"][b]):
            if label < 0:
                continue
            h, w = img.shape[:2]
            px = np.asarray(box) * np.array([w, h, w, h])
            p1 = (int(np.clip(px[0], 0, w - 1)), int(np.clip(px[1], 0, h - 1)))
            p2 = (int(np.clip(px[2], 0, w - 1)), int(np.clip(px[3], 0, h - 1)))
            mask = visualize.rectangle(np.zeros((h, w), bool), p1, p2, True,
                                       2)
            red = (img[mask] == (255, 0, 0)).all(-1)
            green = (img[mask] == (0, 255, 0)).all(-1)
            shares.append(float((red | green).mean()))
    return min(shares), len(shares)


def visualize_flags(root, work, steps):
    """Every other ``LOG.SHOW_*`` flag through the train command line:
    the images by tag, the red GT outlines where the batch's boxes are,
    the run archived under HISTORY_ROOT, and ms a step with the flags off
    and on."""
    runs = {}
    for on in (False, True):
        res, rec, launches, seen, cfg = flags_run(root, work, steps, on)
        # the first logged step has no window (fit's first window starts
        # after it)
        ms = [1e3 * BATCH / m["ips"] for m in res["losses"] if m["ips"] > 0]
        eval_batches = -(-len(dataset_factory("eval", cfg).dataset)
                         // cfg.DATASET.EVAL_BATCH_SIZE)
        norms = sum(isinstance(m, BatchNorm2d)
                    for m in res["state"].model.modules())
        want = {"nms_mask": 0, "nms_rows": eval_batches,
                "bn_eval": norms * eval_batches, "bn_eval_backward_dx": 0}
        if launches != want or res["step"] != steps or not all(
                math.isfinite(m["loss"]) for m in res["losses"]):
            raise AssertionError("flags {}: launches {} against {}, step "
                                 "{}".format(on, launches, want, res["step"]))
        runs[on] = {"ms_per_step": ms, "median_ms": float(np.median(ms)),
                    "launches": launches, "history": res["history"]}
        if not on:
            if rec.images or rec.curves:
                raise AssertionError("flags off, images logged")
            continue
        tags = rec.tags()
        dumps = {s: [step for t, _, step in rec.images
                     if t == "augmentation/" + s] for s in AUG_STAGES}
        items = sorted(set(dumps["0_input"]))
        anchors = [t for t in tags if t.startswith("base/feature_map_")]
        slots = sum(PriorBoxSSD(cfg).num_priors)
        detections = [r for r in rec.images if r[0] == "eval/detections"]
        with_dets = [cls for cls, _, prec, _ in seen[-1]
                     if hasattr(prec, "__len__") and len(prec)]
        share, gt_boxes = red_gt_share(detections,
                                       dataset_factory("eval", cfg),
                                       cfg.MODEL.IMAGE_SIZE)
        history = sorted(os.listdir(res["history"]))
        if not (1 <= len(items) <= 8 and items == list(range(len(items)))
                and all(sorted(v) == items for v in dumps.values())):
            raise AssertionError("augmentation dumps {}".format(dumps))
        if len(anchors) != slots or len(set(anchors)) != slots:
            raise AssertionError("{} anchor maps for {} (source, slot) "
                                 "pairs".format(len(anchors), slots))
        if len(detections) != 4 or [t for t, _ in rec.curves] != [
                "pr/" + c for c in with_dets]:
            raise AssertionError("eval images {}, curves {} for classes "
                                 "{}".format(len(detections), rec.curves,
                                             with_dets))
        if not share >= 0.5:
            raise AssertionError("GT outlines: only {:.2f} of one box's "
                                 "outline is red or green".format(share))
        if "rfbnet300_vgg16_voc.json" not in history:
            raise AssertionError("history backup {}".format(history))
        runs[on].update(dumped_items=len(items), anchor_maps=len(anchors),
                        eval_images=len(detections), pr_curves=len(
                            rec.curves), gt_boxes_checked=gt_boxes,
                        lowest_gt_outline_share=share, history_files=history)
    return {"cfg": "rfbnet300_vgg16_voc", "dtype": "bfloat16", "batch": BATCH,
            "steps": steps, "off": runs[False], "on": runs[True]}


def visualize_demos(work, n_frames=20):
    """The demos on SSD300 (seeded served weights): ``detect_img`` on one
    PPM, its rows equal to ``Detector``'s on that image and its output
    changed only in green; ``live --headless`` over ``n_frames`` PPM
    frames given as a pattern, one ``nms_rows`` launch a frame, frame 0's
    rows equal to ``detect_img``'s."""
    frames = os.path.join(work, "frames")
    os.makedirs(frames)
    rng = np.random.RandomState(9)
    for i in range(n_frames):
        write_ppm(os.path.join(frames, "{:04d}.ppm".format(i)),
                  rng.randint(0, 256, (375, 500, 3)).astype(np.uint8))
    first, out = os.path.join(frames, "0000.ppm"), os.path.join(work,
                                                               "out.ppm")
    reset_counts()
    got = detect_img.main(["--image", first, "--out", out, "--conf", "0.05"])
    image_launches = counts()
    cfg = load_cfg()
    det = Detector(cfg, random_state_dict(cfg, seed=0))
    src = imread(first)
    want = det(augment.resize_u8(src, cfg.MODEL.IMAGE_SIZE)[None])["rows"]
    drawn = imread(out)
    changed = np.any(drawn != src, axis=-1)
    if not np.array_equal(got["rows"], want[0].cpu().numpy()):
        raise AssertionError("detect_img rows != Detector's")
    if got["kept"] < 1 or not (drawn[changed] == (0, 255, 0)).all():
        raise AssertionError("detect_img drew {} boxes; changed pixels not "
                             "all green".format(got["kept"]))
    reset_counts()
    stream = live.main(["--source", os.path.join(frames, "%04d.ppm"),
                        "--headless"])
    live_launches = counts()
    if stream["frames"] != n_frames or live_launches != {
            "nms_mask": 0, "nms_rows": n_frames} or image_launches != {
            "nms_mask": 0, "nms_rows": 1}:
        raise AssertionError("live: {} frames, launches {} (detect_img "
                             "{})".format(stream["frames"], live_launches,
                                          image_launches))
    if not np.array_equal(stream["first_rows"], got["rows"]):
        raise AssertionError("live frame 0 rows != detect_img's")
    return {"cfg": "ssd_vgg16_voc", "detect_img_kept": got["kept"],
            "changed_pixels": int(changed.sum()),
            "launches": {"detect_img": image_launches,
                         "live": live_launches},
            "frames": stream["frames"], "live_fps": stream["fps"]}


def phase_visualize(n_train=288, n_test=32, steps=8):
    """(a) the eval-mode norm's backward entries against their plain
    version, (b) the debug entry with saliency on RFBNet300, (c) every
    other ``LOG.SHOW_*`` flag through the train command line, (d) the
    demos; on a seeded VOC tree of 300x300 PPM images under ``build/``,
    9 train batches: the flags' 8 steps stay inside one epoch, where the
    loader does not restart its threads."""
    t0 = time.perf_counter()
    cases = [check_bn_backward(*case, timed=i == 0)
             for i, case in enumerate(BN_BACKWARD_CASES)]
    torch.cuda.empty_cache()
    bn_s = time.perf_counter() - t0
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_visualize_",
                            dir=build.BUILD_DIR.parent)
    try:
        root = os.path.join(work, "voc")
        write_voc_tree(root, (("trainval", n_train), ("test", n_test)),
                       seed=8, sizes=((300, 300),))
        seconds = {"bn_backward": bn_s}
        t0 = time.perf_counter()
        debug = visualize_debug(root, work)
        seconds["debug"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        flags = visualize_flags(root, work, steps)
        seconds["flags"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        demos = visualize_demos(work)
        seconds["demos"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = {"phase": "visualize", "bn_backward": cases, "debug": debug,
              "flags": flags, "demos": demos, "seconds": seconds,
              "nvidia_smi": power_limit()}
    emit(result)
    return result


# --- ddp: data parallelism across processes (odtpu_torch.parallel) ---

DDP_TIMEOUT = 300  # seconds a launch of the ddp phase may take


def start(cmd, log):
    """Start ``cmd`` from the checkout's root in a session of its own, its
    output to ``log``; returns a handle for :func:`finish`."""
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)), start_new_session=True)
    return proc, cmd, log, time.perf_counter(), time.time()


def stop(handle):
    """End a :func:`start`ed command and what it started: SIGTERM to its
    session (``torch.distributed.run`` passes it on to its workers, which
    run in sessions of their own), SIGKILL after 30 s."""
    proc = handle[0]
    if proc.poll() is not None:
        return
    os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish(handle, timeout=DDP_TIMEOUT):
    """Wait for a :func:`start`ed command, killing its whole session at
    ``timeout`` seconds from its start; returns its seconds, or raises
    with its log's tail when it failed."""
    proc, cmd, log, t0, _ = handle
    try:
        rc = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        stop(handle)
        rc = "timeout"
    if rc != 0:
        with open(log) as f:
            text = f.read()
        # the first error raised (the rank that failed first), and the end
        first = re.search(r"^(\[rank\d+\]: )?[\w.]*(Error|Exception)\b.*$",
                          text, re.M)
        head = first.group(0)[:2000] + "\n...\n" if first else ""
        raise AssertionError("{} exited {}:\n{}{}".format(
            " ".join(cmd), rc, head, text[-4000:]))
    return time.perf_counter() - t0


def torchrun(nproc, *args):
    """``python -m torch.distributed.run`` of this script's ``args`` on
    ``nproc`` local processes (a rendezvous on a free local port)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), os.path.abspath(__file__),
            *args]


def timed_all_reduces():
    """Wrap ``parallel.all_reduce_grads`` (the train step's gradient
    all-reduce) in CUDA events; returns the list of (start, end) pairs
    it fills."""
    from odtpu_torch import parallel
    events, all_reduce = [], parallel.all_reduce_grads

    def timed(params, *args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        all_reduce(params, *args)
        end.record()
        events.append((start, end))

    parallel.all_reduce_grads = timed
    return events


def ddp_fit(work, tag, args, events, entered):
    """The train command line's ``setup`` and ``run`` of ``args`` (in this
    rank's process group, if any) on ``work``'s tree, every step logged;
    writes what it read to ``<tag>_rank<r>.json``, with the wall clock at
    which the process ``entered`` its work and at which it wrote."""
    from odtpu_torch import parallel
    t0 = time.perf_counter()
    del events[:]
    cfg, out_dir, _ = train.setup(args)
    cfg.DATASET.DATASET_DIR = os.path.join(work, "voc")
    cfg.GENERAL.HISTORY_ROOT = os.path.join(work, "history_" + tag)
    cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
    cfg.TRAIN.LOG_LOSS_ITER = 1
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    cfg.DATASET.NUM_WORKERS = 4
    # the uint8 path: the host's C++ sampler, the distortion on the card
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    reset_counts()
    res = train.run(args, cfg, out_dir, "")
    torch.cuda.synchronize()
    params = list(res["state"].model.parameters())
    n_test = len(VOCDetection(cfg.DATASET.DATASET_DIR,
                              cfg.DATASET.TEST_SETS))
    out = {"rank": parallel.rank(), "world": parallel.world(),
           "backend": (torch.distributed.get_backend()
                       if parallel.initialized() else None),
           "device": args.device, "cfg": args.cfg_name,
           "batch": cfg.DATASET.TRAIN_BATCH_SIZE,
           "losses": res["losses"], "evals": res["evals"],
           "ckpt_steps": res["ckpt_steps"], "launches": counts(),
           "bn_eval": batch_norm.LAUNCHES,
           "norms": sum(isinstance(m, BatchNorm2d)
                        for m in res["state"].model.modules()),
           "eval_batches": -(-len(range(parallel.rank(), n_test,
                                         parallel.world()))
                             // cfg.DATASET.EVAL_BATCH_SIZE),
           "grad_bytes": sum(p.numel() * p.element_size() for p in params),
           "all_reduce_ms": [s.elapsed_time(e) for s, e in events],
           "seconds": time.perf_counter() - t0, "entered": entered,
           "written": time.time()}
    with open(os.path.join(work, "{}_rank{}.json".format(
            tag, out["rank"])), "w") as f:
        json.dump(out, f)


def same_on_ranks(run):
    """Whether a :func:`family_parity_step` result (its loss, momenta and
    running statistics) is bit-equal on every rank."""
    from odtpu_torch import parallel
    flat = torch.cat([torch.tensor([run["loss"]], dtype=torch.float64)]
                     + [t.flatten() for part in ("momentum", "stats")
                        for t in run[part].values()])
    first = flat.clone()
    torch.distributed.broadcast(first, 0)
    return bool(parallel.global_sum(torch.tensor(
        int(not torch.equal(first, flat)))) == 0)


def ddp_steps(work, device):
    """One step of each :data:`DDP_STEPS` case on this rank's block of the
    global batch (:func:`family_parity_step`), compared across the ranks;
    rank 0 writes the results to ``steps.pt`` (the momenta in the step's
    dtype)."""
    from odtpu_torch import parallel
    r, w = parallel.rank(), parallel.world()
    out = {}
    for case in DDP_STEPS:
        t0 = time.perf_counter()
        name, dtype, cudnn = case
        images, boxes, labels, params, weights = ddp_step_inputs(name)
        b = images.shape[0] // w
        rows = slice(r * b, (r + 1) * b)
        with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            run = family_parity_step(
                device, dtype, name, weights,
                (images[rows], boxes[rows], labels[rows]),
                {k: v[rows] for k, v in params.items()})
        del run["masks"]
        run["ranks_equal"] = same_on_ranks(run)
        run["momentum"] = {k: v.to(getattr(torch, dtype))
                           for k, v in run["momentum"].items()}
        run["seconds"] = time.perf_counter() - t0
        out["/".join(map(str, case))] = run
    if r == 0:
        torch.save(out, os.path.join(work, "steps.pt"))


def ddp_child(argv):
    """``python chip_smoke.py --ddp_child MODE WORK [train options]``, a
    process of the ddp phase, cuDNN deterministic. MODE ``world2``: two
    ranks on gloo, both on cuda:0 (as ``parallel.distributed`` joins a
    group, with gloo for NCCL), run :func:`ddp_steps`, then the train
    options, tagged ``gloo``. MODE ``world1``: the train options as they
    are (``plain``), then with ``--multihost`` (``nccl``), one after the
    other in this process, once the parent has written ``WORK/go`` (it
    starts this launch early, so that its start-up overlaps the world-2
    launch, and lets it train once that one is done)."""
    from odtpu_torch import parallel
    entered = time.time()
    mode, work, train_argv = argv[0], argv[1], argv[2:]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    events = timed_all_reduces()
    if mode == "world2":
        device = parallel.init_distributed("cuda:0", "gloo")
        try:
            ddp_steps(work, device)
            ddp_fit(work, "gloo", train.parse_args(train_argv + [
                "--multihost", "--device", str(device),
                "--output_dir", os.path.join(work, "gloo")]), events,
                entered)
        finally:
            parallel.shutdown()
        return
    go = os.path.join(work, "go")
    while not os.path.exists(go):
        if time.time() - entered > DDP_TIMEOUT:
            raise TimeoutError("no {} after {} s".format(go, DDP_TIMEOUT))
        time.sleep(0.1)
    entered = time.time()
    for tag, extra in (("plain", []), ("nccl", ["--multihost"])):
        args = train.parse_args(train_argv + extra + [
            "--output_dir", os.path.join(work, tag)])
        with parallel.distributed(args):
            ddp_fit(work, tag, args, events, entered)


# (configuration, dtype, cuDNN) of the world-2 steps: SSD300 in float32
# with cuDNN off (each image's convs the same at any batch, so only the
# sums over the ranks differ; with cuDNN, whose algorithms depend on the
# batch size, a step of 2 + 2 images lay 1.6e-3 from one of 4: PERF.md),
# RFBNet300 (50 batch norms) in float64
DDP_STEPS = (("ssd_vgg16_voc", "float32", False),
             ("rfbnet300_vgg16_voc", "float64", True))
# the limits of a rank's updates and running statistics against the
# one-process step: train_parity's without cuDNN, and 1e-9 in float64
DDP_LIMITS = {DDP_STEPS[0]: 1e-3, DDP_STEPS[1]: 1e-9}
# what --multihost picks for one process a card
WORLD1_BACKEND = "nccl"


def ddp_step_inputs(name, batch=4):
    """The global batch of a world-2 step, the same in every process:
    :func:`parity_batch` images and GT at ``name``'s size, seeded
    photometric parameters and :func:`random_state_dict`'s weights."""
    cfg = train_cfg("float32", name)
    images, boxes, labels = parity_batch(batch, cfg=cfg)
    params = draw_params(batch, torch.Generator().manual_seed(5))
    return images, boxes, labels, params, random_state_dict(cfg, seed=0)


def phase_ddp(n_train=320, n_test=128, steps=10):
    """Data parallelism through the train command line, one process a
    rank, launched by ``python -m torch.distributed.run`` (:func:`ddp_child`):

    (b) two ranks on gloo, both on cuda:0 (NCCL refuses two ranks on one
    card): one step of each :data:`DDP_STEPS` case on its 2 of 4 images,
    held to the same step of one process on the 4 (run here meanwhile)
    within :data:`DDP_LIMITS`, the ranks bit-equal; then, in the same
    processes, RFBNet300 ``--multihost`` for 4 steps (bf16, 16 images a
    rank) and one validation, each rank on its half of the test set: one
    ``nms_rows`` launch an eval batch and one ``bn_eval`` a norm an eval
    batch on each rank, the same losses and mAP on both, one checkpoint;
    (a) in one process, SSD300 (bf16, batch 32, the uint8 path) for
    ``steps`` steps and one validation without ``--multihost``,
    then with it at world 1 on NCCL: equal losses and mAP, ms a step
    of both, and the NCCL all-reduce's ms of SSD300's gradients."""
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ddp_",
                            dir=build.BUILD_DIR.parent)
    world1 = world2 = None
    try:
        write_voc_tree(os.path.join(work, "voc"),
                       (("trainval", n_train), ("test", n_test)))
        w = random_state_dict(load_cfg(), seed=0)[
            "backbone.conv1_1.conv.weight"]
        basenet = os.path.join(work, "basenet.npz")
        np.savez(basenet, **{"conv1_1/kernel": w.permute(2, 3, 1, 0).numpy()})
        common = ["--basenet", basenet]

        # (b): the two ranks, and meanwhile the one-process steps here and
        # the start-up of (a)'s process, which waits for work/go
        rfb = common + ["--cfg_name", "rfbnet300_vgg16_voc", "--max_iter",
                        "4"]
        world2 = start(torchrun(2, "--ddp_child", "world2", work, *rfb),
                       os.path.join(work, "world2.log"))
        world1 = start(torchrun(1, "--ddp_child", "world1", work, *common,
                                "--max_iter", str(steps)),
                       os.path.join(work, "world1.log"))
        began = {"world2": world2[-1], "world1": world1[-1]}
        one = {}
        for case in DDP_STEPS:
            name, dtype, cudnn = case
            images, boxes, labels, params, weights = ddp_step_inputs(name)
            with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                one[case] = family_parity_step("cuda", dtype, name, weights,
                                               (images, boxes, labels),
                                               params)
        seconds = {"world2": finish(world2)}
        ranks = torch.load(os.path.join(work, "steps.pt"), weights_only=False)
        step_lines, failing = [], []
        for case in DDP_STEPS:
            key, limit, ref = "/".join(map(str, case)), DDP_LIMITS[case], \
                one[case]
            r0 = ranks[key]
            r0["momentum"] = {k: v.double() for k, v in r0["momentum"].items()}
            updates = momentum_errors(r0["momentum"], ref["momentum"])
            stats = stats_errors(r0["stats"], ref["stats"])
            worst = max(updates, key=updates.get)
            line = {"cfg": case[0], "dtype": case[1], "cudnn": case[2],
                    "limit": limit, "loss": r0["loss"],
                    "loss_one_process": ref["loss"],
                    "num_pos": r0["num_pos"],
                    "seconds_a_rank": r0["seconds"],
                    "max_update_error": updates[worst], "worst": worst,
                    "global_update_error": global_error(r0["momentum"],
                                                        ref["momentum"]),
                    "max_stats_error": max(stats.values(), default=0.0),
                    "running_stats": len(stats) // 2,
                    "ranks_equal": r0["ranks_equal"]}
            step_lines.append(line)
            failing += ["{} {} {}".format(key, k, v)
                        for k, v in {**updates, **stats}.items()
                        if not v <= limit]
            if not line["ranks_equal"] or r0["num_pos"] != ref["num_pos"] \
                    or not math.isclose(
                        r0["loss"], ref["loss"], rel_tol=1e-4):
                failing.append("{}: {}".format(key, line))
        del one, ranks
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "ddp_steps", "world": 2, "backend": "gloo",
              "device": "cuda:0 (both ranks)", "steps": step_lines,
              "nvidia_smi": power_limit()})
        if failing:
            raise AssertionError("world-2 steps off the one-process "
                                 "step: {}".format(failing[:20]))

        gloo = []
        for r in range(2):
            with open(os.path.join(work, "gloo_rank{}.json".format(r))) as f:
                gloo.append(json.load(f))

        # (a): the command line without --multihost, then with it at world
        # 1 on NCCL, one after the other in one process
        go = time.time()
        open(os.path.join(work, "go"), "w").close()
        seconds["world1"] = finish(world1)
        seconds["world1_after_go"] = time.time() - go
        runs = {}
        for tag in ("plain", "nccl"):
            with open(os.path.join(work, tag + "_rank0.json")) as f:
                runs[tag] = json.load(f)

        def ms_per_step(run):
            # the first step's line has no window (fit starts the clock
            # after it)
            ms = [1000.0 * run["batch"] / m["ips"] for m in run["losses"]
                  if m["ips"] > 0]
            return float(np.median(ms)), ms

        def same(run):
            return [{k: m[k] for k in ("step", "loss", "loss_loc",
                                       "loss_conf", "num_pos")}
                    for m in run["losses"]], run["evals"]

        lines = {}
        for tag, run in runs.items():
            ms, each = ms_per_step(run)
            lines[tag] = {"world": run["world"], "backend": run["backend"],
                          "ms_per_step": ms, "ms_each": each,
                          "losses": run["losses"], "evals": run["evals"],
                          "launches": run["launches"],
                          "bn_eval": run["bn_eval"],
                          "all_reduce_ms": run["all_reduce_ms"],
                          "seconds": run["seconds"]}
        nccl = runs["nccl"]
        result = {"phase": "ddp", "cfg": "ssd_vgg16_voc", "dtype": "bfloat16",
                  "batch": BATCH, "steps": steps,
                  "train_images": n_train, "test_images": n_test,
                  "world1": lines,
                  "losses_and_map_equal": same(runs["plain"]) == same(nccl),
                  "grad_bytes": nccl["grad_bytes"],
                  "all_reduce_ms_median": float(np.median(
                      nccl["all_reduce_ms"][1:])),
                  "overhead_ms_per_step": lines["nccl"]["ms_per_step"]
                  - lines["plain"]["ms_per_step"],
                  "world2": {"cfg": "rfbnet300_vgg16_voc", "steps": 4,
                             "batch_per_rank": BATCH // 2,
                             "ranks": [{k: g[k] for k in (
                                 "rank", "losses", "evals", "launches",
                                 "bn_eval", "norms", "eval_batches",
                                 "ckpt_steps", "all_reduce_ms", "seconds")}
                                 for g in gloo]},
                  "launch_seconds": seconds,
                  # each launch's seconds before its first process began
                  # its work (world 1: after work/go), and after its last
                  # wrote its results
                  "launch_start_s": {
                      "world2": min(g["entered"] for g in gloo)
                      - began["world2"],
                      "world1": nccl["entered"] - go},
                  "launch_exit_s": {
                      "world2": began["world2"] + seconds["world2"]
                      - max(g["written"] for g in gloo),
                      "world1": began["world1"] + seconds["world1"]
                      - nccl["written"]},
                  "nvidia_smi": power_limit()}
        emit(result)
        for tag, run in runs.items():
            want = {"nms_mask": 0, "nms_rows": run["eval_batches"]}
            if run["launches"] != want or run["bn_eval"] != 0:
                raise AssertionError("{}: launches {} bn_eval {}".format(
                    tag, run["launches"], run["bn_eval"]))
        if not result["losses_and_map_equal"] or len(
                nccl["all_reduce_ms"]) != steps or runs["plain"][
                    "all_reduce_ms"] or nccl["backend"] != WORLD1_BACKEND:
            raise AssertionError("world 1 on NCCL against the plain run: "
                                 "{}".format(lines))
        g0, g1 = gloo
        for g in gloo:
            if g["launches"] != {"nms_mask": 0,
                                 "nms_rows": g["eval_batches"]} \
                    or g["bn_eval"] != g["norms"] * g["eval_batches"] \
                    or g["ckpt_steps"] != [4] or len(g["all_reduce_ms"]) != 4 \
                    or not all(math.isfinite(m["loss"]) and m["num_pos"] > 0
                               for m in g["losses"]):
                raise AssertionError("world-2 RFBNet300 rank {}: {}".format(
                    g["rank"], {k: g[k] for k in ("launches", "bn_eval",
                                                  "norms", "ckpt_steps")}))
        if g0["losses"] and [dict(m, ips=0) for m in g0["losses"]] != [
                dict(m, ips=0) for m in g1["losses"]] \
                or g0["evals"] != g1["evals"] or len(g0["evals"]) != 1:
            raise AssertionError("the two ranks disagree: {} {}".format(
                g0["evals"], g1["evals"]))
        return result
    finally:
        for handle in (world1, world2):  # a failure left them running
            if handle is not None:
                stop(handle)
        shutil.rmtree(work, ignore_errors=True)


def ddp_launches(ddp, name):
    """The ``ddp`` phase's launches of kernel entry ``name`` by run: the
    world-1 runs, and each rank of the world-2 RFBNet300 run."""
    def of(run):
        return run["bn_eval"] if name == "bn_eval" else run["launches"][name]
    return {**{"ssd300_world1_" + tag: of(run)
               for tag, run in ddp["world1"].items()},
            "rfbnet300_world2_gloo": [of(r) for r in ddp["world2"]["ranks"]]}


# --- mesh: tensor-parallel and spatial meshes (parallel.mesh, .spatial) ---

MESH_TIMEOUT = 300  # seconds a launch of the mesh phase may take
# (D, M, S) of each launch; every one takes SSD300's float32 step
MESH_LAYOUTS = ("1x2x1", "1x1x2", "1x2x2")
# float64 steps are held to one process at 1e-9. A float32 step's convs
# on a channel block or a slab with its halo are other GEMM shapes and
# round otherwise: it is held at 1e-6 to one process running the same
# shapes (:func:`rank_shapes`), whose distance from the plain step is
# printed beside float32's own from float64
MESH_STEP_LIMITS = {"ssd300_f32": 1e-6, "ssd300_f64": 1e-9,
                    "rfbnet300_f64": 1e-9}
MESH_OUTPUT_LIMIT = 1e-5  # relative L2 of the gathered loc and conf
MESH_EVAL_IMAGES = 4
# TPU.REMAT's steps on the mesh: SSD300's float32 step at every layout
# against the same layout's step without remat, RFBNet300's float64 one
# at (1, 2, 2) against one process's step (relative L2 a tensor)
MESH_REMAT_KEYS = {"1x2x1": ("ssd300_f32",), "1x1x2": ("ssd300_f32",),
                   "1x2x2": ("ssd300_f32", "rfbnet300_f64")}
MESH_REMAT_LIMITS = {"ssd300_f32": 1e-7, "rfbnet300_f64": 1e-9}


def mesh_cfg(name, dtype, layout):
    cfg = train_cfg(dtype, name)
    cfg.TRAIN.OPTIMIZER.LR = 1e-3  # the default
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL, cfg.TPU.MESH_SPATIAL = layout
    return cfg


def mesh_step(work, key, layout, device, remat=False):
    """One train step of the ``key`` case (``WORK/<key>.pt``: its config,
    dtype, full weights and batch) on the current mesh, under
    ``TPU.REMAT`` with ``remat``: the metrics, the full momenta and
    running statistics (rank 0's, gathered), this rank's parameter and
    momentum bytes, its peak memory over the step and what it saved for
    the backward, the halo bytes it sent (by pass: forward, recompute,
    backward) and the step's ms."""
    from odtpu_torch import parallel
    from odtpu_torch.parallel import spatial
    case = torch.load(os.path.join(work, key + ".pt"), weights_only=False)
    cfg = mesh_cfg(case["name"], case["dtype"], layout)
    cfg.TPU.REMAT = remat
    state, priors = create_train_state(cfg, device)
    if case["dtype"] == "float64":
        state.model.double()
        priors = priors.double()
    state.model.load_state_dict(parallel.block_state_dict(
        state.model, case["weights"]))
    step = make_train_step(priors, cfg)
    images, boxes, labels = (t.to(device) for t in case["batch"])
    params = {k: v.to(device) for k, v in case["params"].items()}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sent = dict(spatial.SENT)
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=case["cudnn"], benchmark=False,
                                    deterministic=True, allow_tf32=False), \
            saved_for_backward(state.model) as saved:
        m = step(state, images, boxes, labels, aug_params=params)
        torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - before
    model, opt = state.model, state.optimizer
    moms = parallel.full_optimizer_state(model, opt)["state"]
    names = [k for k, _ in model.named_parameters()]
    full = parallel.full_state_dict(model)
    local = [opt.state[p]["momentum_buffer"] for p in model.parameters()]
    return {"loss": float(m["loss"]), "num_pos": int(m["num_pos"]),
            "momentum": {names[i]: s["momentum_buffer"].double().cpu()
                         for i, s in moms.items()},
            "stats": {k: full[k].double().cpu() for k in full
                      if k.endswith(("running_mean", "running_var"))},
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "momentum_bytes": sum(t.numel() * t.element_size()
                                  for t in local),
            "peak_step_bytes": peak,
            # the step's activations: its peak less the gradients and the
            # momenta the first step makes, a tensor each a parameter
            "activation_bytes": peak - 2 * sum(
                t.numel() * t.element_size() for t in local),
            "halo_bytes": sum(spatial.SENT.values()) - sum(sent.values()),
            "halo_bytes_by_pass": {k: v - sent[k]
                                   for k, v in spatial.SENT.items()},
            "ms": ms, **saved}


@contextlib.contextmanager
def saved_for_backward(model):
    """Count, in the block, the bytes of the storages autograd saves for
    the backward (each once, the parameters' left out), and of those the
    bytes that hold a halo copy: a map's rows fetched and padded for an
    H-local op (``parallel.spatial``'s ``_halo`` and ``fetch`` outputs).
    Yields the dict it fills: ``saved_bytes``, ``halo_copy_bytes``."""
    from odtpu_torch.parallel import spatial
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    copies, seen = {}, set()
    out = {"saved_bytes": 0, "halo_copy_bytes": 0}

    def noted(fn):
        def call(*args, **kwargs):
            t = fn(*args, **kwargs)
            copies[t.untyped_storage().data_ptr()] = weakref.ref(t)
            return t
        return call

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params and ptr not in seen:
            seen.add(ptr)
            n = t.untyped_storage().nbytes()
            out["saved_bytes"] += n
            copy = copies.get(ptr)
            if copy is not None and copy() is not None:
                out["halo_copy_bytes"] += n
        return t

    original = spatial._halo, spatial.fetch
    spatial._halo = noted(spatial._halo)
    spatial.fetch = noted(spatial.fetch)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield out
    finally:
        spatial._halo, spatial.fetch = original


@contextlib.contextmanager
def rank_shapes(blocks=1, slabs=1):
    """In the block every conv runs as the ranks of a (1, ``blocks``,
    ``slabs``) mesh run it, in one process: a conv of at least
    ``parallel.mesh.TP_MIN_CHANNELS`` output channels divisible by
    ``blocks`` as ``blocks`` convs of a block of them each, and each conv
    on ``slabs`` slabs of its output rows (``parallel.spatial.slab``),
    each from its input window cut out of the whole map and zero-padded
    as a rank's halo is; the outputs concatenated. Each block reads its
    own view of the input, so that the input's gradient sums the slabs'
    halo rows within a block first and then the blocks, as the ranks'
    row exchanges and model all-reduce do."""
    from odtpu_torch import parallel
    from odtpu_torch.parallel import spatial
    conv2d = spatial.conv2d

    def on_slabs(x, weight, bias, stride, padding, dilation):
        (kh, _), (sh, sw) = weight.shape[2:], spatial._pair(stride)
        (ph, pw), (dh, dw) = spatial._pair(padding), spatial._pair(dilation)
        h = x.shape[2]
        h_out = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        outs = []
        for i in range(slabs):
            o0, o1 = spatial.slab(h_out, slabs, i)
            if o0 < o1:
                lo, hi = spatial.window(o0, o1, kh, sh, ph, dh)
                a, b = max(lo, 0), min(hi, h)
                ext = x[:, :, a:b]
                if a - lo or hi - b:
                    ext = F.pad(ext, (0, 0, a - lo, hi - b))
                outs.append(conv2d(ext, weight, bias, (sh, sw), (0, pw),
                                   (dh, dw)))
        return torch.cat(outs, 2)

    def run(x, weight, bias, *args):
        out = weight.shape[0]
        if out < parallel.mesh.TP_MIN_CHANNELS or out % blocks:
            return on_slabs(x, weight, bias, *args)
        c = out // blocks
        return torch.cat([on_slabs(x.view_as(x), weight[i * c:(i + 1) * c],
                                   None if bias is None
                                   else bias[i * c:(i + 1) * c], *args)
                          for i in range(blocks)], 1)

    spatial.conv2d = run
    try:
        yield
    finally:
        spatial.conv2d = conv2d


def relu_signs(work, key, device):
    """(elements, elements whose sign differs) of the Conv ReLUs' outputs
    between two train-phase forwards of the ``key`` case's augmented
    batch in one process: as it is and with its wide convs as two
    channel blocks (:func:`rank_shapes`)."""
    case = torch.load(os.path.join(work, key + ".pt"), weights_only=False)
    cfg = mesh_cfg(case["name"], case["dtype"], (1, 1, 1))
    state, priors = create_train_state(cfg, device)
    state.model.load_state_dict(case["weights"])
    images = make_train_step(priors, cfg).augment(
        case["batch"][0].to(device), 0,
        {k: v.to(device) for k, v in case["params"].items()})
    masks, runs = relu_masks(state.model), []
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=case["cudnn"], benchmark=False, deterministic=True,
            allow_tf32=False):
        for ctx in (contextlib.nullcontext(), rank_shapes(2)):
            with ctx:
                state.model(images, phase="train")
            runs.append(dict(masks))
    return sum(m.numel() for m in runs[0].values()), relu_flips(*runs)


def mesh_f32_cause(work, one_steps, device):
    """Each layout's float32 SSD300 step in one process with its ranks'
    conv shapes (:func:`rank_shapes`), the float32 step the mesh is held
    to, and why one process's plain step is not: ``{layout: momenta}``,
    and a line of each such step's and of the plain one's distance from
    the float64 step of the same weights and batch (the largest and the
    median error a tensor), of 4 channel blocks' (another rounding), and
    of the ReLU signs that 2 channel blocks flip."""
    exact = one_steps["ssd300_f64"]["momentum"]

    def errors(got, want):
        e = momentum_errors({k: v.double() for k, v in got.items()}, want)
        k = max(e, key=e.get)
        return {"max": e[k], "tensor": k,
                "median": float(np.median(list(e.values())))}

    runs = {}
    for text in MESH_LAYOUTS + ("1x4x1",):
        _, blocks, slabs = (int(v) for v in text.split("x"))
        with rank_shapes(blocks, slabs):
            runs[text] = mesh_step(work, "ssd300_f32", (1, 1, 1),
                                   device)["momentum"]
    plain = one_steps["ssd300_f32"]["momentum"]
    total, flips = relu_signs(work, "ssd300_f32", device)
    line = {"vs_f64": {"plain": errors(plain, exact),
                       **{t: errors(m, exact) for t, m in runs.items()}},
            "vs_plain": {t: errors(m, plain) for t, m in runs.items()},
            "relu_outputs": total, "relu_sign_flips_2_blocks": flips}
    return runs, line


def family_cfg(name, layout=(1, 1, 1), quant=""):
    """Configuration ``name`` for the mesh phase's eval batches: float32
    convs, or int8 ones with the heads in bf16 (``quant``, as served)."""
    cfg = load_cfg(name)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16" if quant else "float32"
    cfg.TPU.QUANT = quant
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL, cfg.TPU.MESH_SPATIAL = layout
    return cfg


def family_eval(cfg, weights, images, device):
    """An eval batch through ``Detector`` (cuDNN deterministic, TF32 off):
    the outputs, the rows, the rows of the plain detect path on the same
    outputs, the ``nms_rows``, ``bn_eval`` and ``torch._int_mm`` launches,
    and the bytes of the convs' cached int8 weight operands."""
    det = Detector(cfg, weights, device=device)
    images = images.to(device)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        reset_counts()
        int_mm = quant.INT_MM_CALLS
        outputs = det.step.forward(images)
        rows = det.step.detect(*outputs)["rows"]
        torch.cuda.synchronize()
        launches = {**counts(), "bn_eval": batch_norm.LAUNCHES,
                    "int_mm": quant.INT_MM_CALLS - int_mm}
        plain = plain_rows(det.step, *outputs)
    cache = sum(t.numel() * t.element_size()
                for m in det.model.modules() if isinstance(m, Conv)
                for k, t in m.int8_cache.items() if k in ("b", "s_w"))
    return {"outputs": [o.cpu() for o in outputs], "rows": rows.cpu(),
            "plain_equal": bool(torch.equal(rows, plain)),
            "launches": launches, "int8_cache_bytes": cache}


def mesh_family(work, name, layout, device, quant=""):
    """An eval batch of configuration ``name`` (``WORK/family_<name>.pt``:
    float32 weights with drawn norms, the images) on the current mesh
    (:func:`family_eval`), in float32 or in int8 (``quant``)."""
    path = os.path.join(work, "family_{}.pt".format(name))
    while not os.path.exists(path + ".done"):
        time.sleep(0.05)
    case = torch.load(path, weights_only=False)
    return family_eval(family_cfg(name, layout, quant), case["weights"],
                       case["images"], device)


def mesh_cli_train(work, device):
    """``odtpu_torch.train``'s command line with ``--multihost
    --mesh_model 2`` (this rank already in the gloo group: NCCL refuses
    two ranks on one card): 4 bf16 SSD300 steps of 32 images and one
    validation, the checkpoint under ``WORK/cli_train``."""
    args = train.parse_args([
        "--cfg_name", "ssd_vgg16_voc", "--multihost", "--mesh_model", "2",
        "--device", str(device), "--max_iter", "4",
        "--output_dir", os.path.join(work, "cli_train")])
    cfg, out_dir, _ = train.setup(args)
    cfg.DATASET.DATASET_DIR = os.path.join(work, "voc")
    cfg.GENERAL.HISTORY_ROOT = os.path.join(work, "history")
    cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
    cfg.TRAIN.LOG_LOSS_ITER = 1
    cfg.TRAIN.OPTIMIZER.LR = 1e-5
    cfg.DATASET.NUM_WORKERS = 2
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    reset_counts()
    res = train.run(args, cfg, out_dir, "")
    return {"losses": res["losses"], "evals": res["evals"],
            "ckpt_steps": res["ckpt_steps"],
            "launches": {**counts(), "bn_eval": batch_norm.LAUNCHES}}


# what the remat run's yml sets over SSD300's defaults (the data tree,
# the run's length and rate): TPU.REMAT on a spatial mesh of 2 ranks
MESH_REMAT_YML = """\
# SSD300 trained under TPU.REMAT on a spatial mesh (chip_smoke.py mesh)
GENERAL:
  HISTORY_ROOT: '{work}/history'
DATASET:
  DATASET_DIR: '{work}/voc'
  TRAIN_SETS: (('2007', 'trainval'),)
  NUM_WORKERS: 2
  DEVICE_PHOTOMETRIC: yes
TRAIN:
  MAX_ITER: 4
  LOG_LOSS_ITER: 1
  OPTIMIZER:
    LR: 1.0e-5   # 1e-3 diverges from the seeded init
TPU:
  REMAT: True
  MESH_SPATIAL: 2
"""


def mesh_cli_remat_train(work, device):
    """``odtpu_torch.train --multihost --cfg <yml>`` at (1, 1, 2), the yml
    (:data:`MESH_REMAT_YML`, written in ``WORK``) setting ``TPU.REMAT``
    and ``TPU.MESH_SPATIAL: 2``: 4 bf16 SSD300 steps of 32 images and one
    validation, the checkpoint under ``WORK/remat_train``; the halo bytes
    this rank sent by pass."""
    from odtpu_torch.parallel import spatial
    path = os.path.join(work, "remat_s2.yml")
    with open(path, "w") as f:
        f.write(MESH_REMAT_YML.format(work=work))
    args = train.parse_args(["--cfg", path, "--multihost", "--device",
                             str(device), "--output_dir",
                             os.path.join(work, "remat_train")])
    cfg, out_dir, _ = train.setup(args)
    if not (cfg.TPU.REMAT is True and cfg.TPU.MESH_SPATIAL == 2):
        raise AssertionError("the yml's TPU keys did not reach the run")
    sent = dict(spatial.SENT)
    reset_counts()
    res = train.run(args, cfg, out_dir, "")
    return {"losses": res["losses"], "evals": res["evals"],
            "ckpt_steps": res["ckpt_steps"],
            "halo_bytes_by_pass": {k: v - sent[k]
                                   for k, v in spatial.SENT.items()},
            "launches": {**counts(), "bn_eval": batch_norm.LAUNCHES}}


def mesh_cli_eval(work, device, tag, extra=(), run="cli_train",
                  dtype="float32"):
    """``odtpu_torch.eval``'s command line on the checkpoint of the run
    ``run`` (:func:`mesh_cli_train`'s by default), in float32 (TF32 off)
    or ``dtype``: its mAP, image and dropped counts, launches (with
    ``torch._int_mm``'s) and (rank 0's) detection files' lines."""
    from odtpu_torch import parallel
    args = cli.parse_args(["--cfg_name", "ssd_vgg16_voc", "--device",
                           str(device), "--ckpt",
                           os.path.join(work, run, "ckpt"),
                           "--output_dir", os.path.join(work, tag)]
                          + list(extra))
    cfg = cli.setup(args)
    cfg.DATASET.DATASET_DIR = os.path.join(work, "voc")
    cfg.TPU.COMPUTE_DTYPE = dtype
    reset_counts()
    int_mm = quant.INT_MM_CALLS
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        res = cli.run(args, cfg)
    out = {"maps": res["maps"], "weights": res["weights"],
           "images": res["timing"]["images"],
           "dropped": res["timing"]["dropped_dets"],
           "launches": {**counts(), "bn_eval": batch_norm.LAUNCHES,
                        "int_mm": quant.INT_MM_CALLS - int_mm}}
    if parallel.is_main():
        out["lines"] = det_lines(os.path.join(work, tag))
    return out


def det_lines(directory):
    """{(class, image): [(score, x1, y1, x2, y2), ...]} of the VOC
    detection files ``det_<set>_<cls>.txt`` in ``directory``."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("det_") and name.endswith(".txt")):
            continue
        cls = name[:-4].split("_", 2)[2]
        with open(os.path.join(directory, name)) as f:
            for line in f:
                img, *values = line.split()
                out.setdefault((cls, img), []).append(
                    tuple(float(v) for v in values))
    return out


def det_lines_apart(got, want, score_tol=1.5e-3, box_tol=0.15, rtol=1e-4):
    """The detection-file lines of ``got`` and ``want`` (:func:`det_lines`)
    without a counterpart in the other (same class and image, the score
    within one unit of its printed 3 decimals, the box within one of its
    printed 0.1 px and ``rtol`` of its size, as the rows are held), as
    (side, class, image, line, traced): a line is traced to a tie when
    its score is within ``score_tol`` of its image's lowest kept score in
    its own run (the row cap's cut took another candidate of near-equal
    score)."""
    lowest = {}
    for side, lines in (("got", got), ("want", want)):
        for (cls, img), rows in lines.items():
            low = min(r[0] for r in rows)
            lowest[side, img] = min(lowest.get((side, img), low), low)
    apart = []
    for key in sorted(set(got) | set(want)):
        left, right = list(got.get(key, [])), list(want.get(key, []))
        unmatched = []
        for row in left:
            hit = next((i for i, r in enumerate(right)
                        if abs(r[0] - row[0]) <= score_tol
                        and all(abs(a - b) <= box_tol + rtol * abs(b)
                                for a, b in zip(r[1:], row[1:]))), None)
            if hit is None:
                unmatched.append(("got", row))
            else:
                right.pop(hit)
        unmatched += [("want", row) for row in right]
        for side, row in unmatched:
            low = lowest[side, key[1]]
            apart.append((side, key[0], key[1], row,
                          abs(row[0] - low) <= score_tol))
    return apart


def mesh_child(argv):
    """``python chip_smoke.py --mesh_child DxMxS WORK``, a rank of the mesh
    phase: joins a gloo group on cuda:0, lays out the mesh and runs its
    launch's cases (:func:`phase_mesh`); writes ``WORK/<DxMxS>_rank<r>.pt``."""
    from odtpu_torch import parallel
    text, work = argv
    layout = tuple(int(v) for v in text.split("x"))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    device = parallel.init_distributed("cuda:0", "gloo")
    try:
        parallel.make_mesh(mesh_cfg("ssd_vgg16_voc", "float32", layout),
                           device)
        out = {"rank": parallel.rank(), "layout": layout,
               "coords": (parallel.current().d, parallel.current().m,
                          parallel.current().s), "steps": {},
               "families": {}, "seconds": {}}
        t0 = time.perf_counter()
        keys = ["ssd300_f32", "ssd300_f64"] + (
            ["rfbnet300_f64"] if layout == (1, 2, 2) else [])
        for key in keys:
            out["steps"][key] = mesh_step(work, key, layout, device)
        for key in MESH_REMAT_KEYS[text]:
            torch.cuda.empty_cache()
            out["steps"][key + "_remat"] = mesh_step(work, key, layout,
                                                     device, remat=True)
            # the step without remat again, warm as the remat one is:
            # their ms and peaks side by side
            torch.cuda.empty_cache()
            out["steps"][key + "_warm"] = mesh_step(work, key, layout,
                                                    device)
        out["seconds"]["steps"] = time.perf_counter() - t0
        # every process of the phase shares the card: each hands back
        # what its allocator keeps between parts
        torch.cuda.empty_cache()
        if layout != (1, 2, 2):
            t0 = time.perf_counter()
            for name in FAMILIES:
                out["families"][name] = mesh_family(work, name, layout,
                                                    device)
            out["seconds"]["families"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        if layout == (1, 2, 1):
            t0 = time.perf_counter()
            out["int8"] = {name: mesh_family(work, name, layout, device,
                                             "int8") for name in FAMILIES}
            out["seconds"]["int8"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if layout == (1, 2, 1):
            out["cli_train"] = mesh_cli_train(work, device)
            gc.collect()
            torch.cuda.empty_cache()
            parallel.barrier()
            if parallel.is_main():
                open(os.path.join(work, "cli_train.done"), "w").close()
            wait_for(os.path.join(work, "remat_train.done"))
            out["cli_eval_int8"] = mesh_cli_eval(
                work, device, "eval_int8", ["--multihost", "--mesh_model",
                                            "2", "--quant", "int8"],
                run="remat_train", dtype="bfloat16")
        elif layout == (1, 1, 2):
            out["remat_train"] = mesh_cli_remat_train(work, device)
            gc.collect()
            torch.cuda.empty_cache()
            parallel.barrier()
            if parallel.is_main():
                open(os.path.join(work, "remat_train.done"), "w").close()
            wait_for(os.path.join(work, "cli_train.done"))
            out["cli_eval"] = mesh_cli_eval(work, device, "eval_spatial",
                                            ["--multihost",
                                             "--mesh_spatial", "2"])
        out["seconds"]["cli"] = time.perf_counter() - t0
        with open(os.path.join(work, "{}_rank{}.pt".format(
                text, parallel.rank())), "wb") as f:
            torch.save(out, f)
        parallel.barrier()
    finally:
        parallel.shutdown()


def wait_for(path):
    """Wait until ``path`` exists (another launch's mark; the phase's
    timeout ends a wait that never does)."""
    while not os.path.exists(path):
        time.sleep(0.1)


def mesh_inputs(work):
    """The step cases' files: SSD300 in float32 (cuDNN off, as the ddp
    phase holds its float32 step) and in float64, and RFBNet300 in
    float64, each with
    :func:`random_state_dict`'s weights, :func:`parity_batch`'s 2 images
    and seeded photometric parameters."""
    for key, name, dtype, cudnn in (
            ("ssd300_f32", "ssd_vgg16_voc", "float32", False),
            ("ssd300_f64", "ssd_vgg16_voc", "float64", True),
            ("rfbnet300_f64", "rfbnet300_vgg16_voc", "float64", True)):
        cfg = train_cfg("float32", name)
        weights = random_state_dict(cfg, seed=0)
        if dtype == "float64":
            weights = {k: v.double() if v.is_floating_point() else v
                       for k, v in weights.items()}
        torch.save({"name": name, "dtype": dtype, "cudnn": cudnn,
                    "weights": weights,
                    "batch": parity_batch(2, cfg=cfg),
                    "params": draw_params(2, torch.Generator().manual_seed(
                        5))}, os.path.join(work, key + ".pt"))


def mesh_family_one(work, name):
    """Configuration ``name`` in one process on the card: its weights with
    every batch norm drawn by :func:`random_norms` (on the CPU, from the
    first image), written with 4 seeded images for the ranks, and its
    eval batch in float32 and in int8 (:func:`family_eval`)."""
    cfg = family_cfg(name)
    images = torch.from_numpy(random_images(
        MESH_EVAL_IMAGES, cfg.MODEL.IMAGE_SIZE, 11))
    with torch.inference_mode():
        # the norms drawn on the CPU from one image's activations
        cpu = Detector(cfg, random_state_dict(cfg, seed=0), device="cpu")
        random_norms(cpu, images[:1])
        weights = cpu.model.state_dict()
        path = os.path.join(work, "family_{}.pt".format(name))
        torch.save({"weights": weights, "images": images}, path)
        open(path + ".done", "w").close()
    return {"float32": family_eval(cfg, weights, images, "cuda"),
            "int8": family_eval(family_cfg(name, quant="int8"), weights,
                                images, "cuda")}


def rows_apart(got, want, rtol=1e-4, atol=1e-5, tie=1e-5):
    """The rows of ``got`` [B, R, 6] off ``want``'s at (rtol, atol), as
    (image, row, got's row, want's row, traced): a row is traced to a tie
    in scores when ``got``'s row stands in ``want`` at another place
    whose score is within ``tie`` of its own (two near-equal candidates
    swapped), or when its score is within ``tie`` of the image's last
    kept score (the cross-class cut took another of near-equal score)."""
    close = torch.isclose(got, want, rtol=rtol, atol=atol).all(-1)
    out = []
    for b, r in zip(*torch.nonzero(~close, as_tuple=True)):
        b, r = int(b), int(r)
        row, scores = got[b, r], want[b, :, 0]
        near = torch.nonzero((scores - row[0]).abs() <= tie).flatten()
        swapped = any(bool(torch.isclose(row, want[b, q], rtol=rtol,
                                         atol=atol).all()) for q in near)
        kept = scores[scores > 0]
        boundary = len(kept) > 0 and float((row[0] - kept.min()).abs()) \
            <= tie
        out.append((b, r, row.tolist(), want[b, r].tolist(),
                    bool(swapped or boundary)))
    return out


def phase_mesh(n_train=64, n_test=32):
    """Tensor-parallel and spatial meshes, one process a rank on gloo,
    every rank on cuda:0, launched by ``python -m torch.distributed.run``
    running this script (:func:`mesh_child`), cuDNN deterministic:

    - at (1, 2, 1), (1, 1, 2) and (1, 2, 2): one step of full-width
      SSD300 (batch 2) in float32 (TF32 and cuDNN off) and in float64,
      held to the same step in one process here, float32's run with the
      layout's conv shapes (:func:`mesh_f32_cause`;
      :data:`MESH_STEP_LIMITS`, relative L2 a tensor, gathered); at
      (1, 2, 2) also RFBNet300 in float64;
    - at (1, 2, 1) and (1, 1, 2): an eval batch of 4 images of every
      configuration of ``families`` in float32, its batch norms drawn at
      random: the gathered loc and conf within :data:`MESH_OUTPUT_LIMIT`
      of one process's, the rows at rtol 1e-4 and atol 1e-5 (a row off
      must sit at a tie in scores), the rows equal to the plain detect
      path's on the same outputs, one ``nms_rows`` launch on each rank;
    - ``TPU.REMAT``: SSD300's float32 step again under it at each layout,
      within 1e-7 of the same layout's step without it, and RFBNet300's
      float64 one at (1, 2, 2) within 1e-9 of one process's
      (:data:`MESH_REMAT_LIMITS`), the recompute's halo bytes equal to
      the forward's; peak memory, halo bytes by pass and ms a step with
      and without it;
    - int8 serving at (1, 2, 1): every configuration of ``families``
      served in int8 convs (bf16 heads) at batch 4: loc, conf and rows
      bit-equal to one process's int8 here, the same ``torch._int_mm``,
      ``bn_eval`` and ``nms_rows`` launches a rank as one process makes,
      and the cached int8 weight bytes a rank against world 1's;
    - the command lines: ``odtpu_torch.train --multihost --mesh_model 2``
      (4 bf16 SSD300 steps of 32 images and a validation) at (1, 2, 1),
      its checkpoint scored by ``odtpu_torch.eval --multihost
      --mesh_spatial 2`` at (1, 1, 2) and by ``odtpu_torch.eval`` at
      world 1 here, in float32: their detection files' lines equal but
      at ties (:func:`det_lines_apart`); ``odtpu_torch.train --multihost
      --cfg <yml>`` at (1, 1, 2), the yml setting ``TPU.REMAT`` and
      ``TPU.MESH_SPATIAL: 2`` (4 steps and a validation), its checkpoint
      scored by ``odtpu_torch.eval --multihost --mesh_model 2 --quant
      int8`` at (1, 2, 1) and by ``odtpu_torch.eval --quant int8`` at
      world 1 here, in bf16: their detection files bit-equal;
    - per rank: parameter and momentum bytes at M = 2 against world 1,
      peak memory of the step at S = 2 against world 1 (same batch), its
      activations (the peak less the gradients and new momenta) and the
      bytes saved for its backward, of them the halo copies
      (:func:`saved_for_backward`), the halo bytes a step and its ms
      (gloo sharing one card: these show correctness and memory, not
      scaling)."""
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_",
                            dir=build.BUILD_DIR.parent)
    launches = []
    t_start = time.perf_counter()
    try:
        write_voc_tree(os.path.join(work, "voc"),
                       (("trainval", n_train), ("test", n_test)), seed=4)
        mesh_inputs(work)
        for text in MESH_LAYOUTS:
            n = int(np.prod([int(v) for v in text.split("x")]))
            launches.append(start(torchrun(n, "--mesh_child", text, work),
                                  os.path.join(work, text + ".log")))
        seconds = {}
        t0 = time.perf_counter()
        one_families = {name: mesh_family_one(work, name)
                        for name in FAMILIES}
        seconds["families_one_process"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one_steps = {key: mesh_step(work, key, (1, 1, 1), "cuda")
                     for key in MESH_STEP_LIMITS}
        seconds["steps_one_process"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        shaped, f32_cause = mesh_f32_cause(work, one_steps, "cuda")
        seconds["f32_cause"] = time.perf_counter() - t0
        for handle in launches:
            seconds["launch_" + handle[1][-2]] = finish(handle,
                                                        MESH_TIMEOUT)
        ranks = {}
        for text in MESH_LAYOUTS:
            n = int(np.prod([int(v) for v in text.split("x")]))
            ranks[text] = [torch.load(os.path.join(
                work, "{}_rank{}.pt".format(text, r)), weights_only=False)
                for r in range(n)]
        t0 = time.perf_counter()
        world1_eval = mesh_cli_eval(work, "cuda", "eval_world1")
        seconds["cli_eval_world1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        world1_int8 = mesh_cli_eval(work, "cuda", "eval_int8_world1",
                                    ["--quant", "int8"], run="remat_train",
                                    dtype="bfloat16")
        seconds["cli_eval_int8_world1"] = time.perf_counter() - t0
    finally:
        for handle in launches:
            stop(handle)
        shutil.rmtree(work, ignore_errors=True)
    failing = []
    steps = []
    for text, rs in ranks.items():
        for key, ref in one_steps.items():
            if key not in rs[0]["steps"]:
                continue
            got = rs[0]["steps"][key]
            limit = MESH_STEP_LIMITS[key]
            updates = momentum_errors(got["momentum"], ref["momentum"])
            stats = stats_errors(got["stats"], ref["stats"])
            worst = max(updates, key=updates.get)
            held = {**updates, **stats}
            if key == "ssd300_f32":  # held to its ranks' shapes
                held = momentum_errors(got["momentum"], {
                    k: v.double() for k, v in shaped[text].items()})
            line = {"layout": text, "case": key, "limit": limit,
                    "max_held_error": max(held.values(), default=0.0),
                    "loss": got["loss"],
                    "loss_one_process": ref["loss"],
                    "num_pos": got["num_pos"],
                    "max_update_error": updates[worst], "worst": worst,
                    "max_stats_error": max(stats.values(), default=0.0),
                    "ranks": [{k: r["steps"][key][k] for k in (
                        "param_bytes", "momentum_bytes", "peak_step_bytes",
                        "activation_bytes", "saved_bytes",
                        "halo_copy_bytes", "halo_bytes", "ms")}
                              for r in rs]}
            steps.append(line)
            failing += ["{} {} {} {}".format(text, key, k, v)
                        for k, v in held.items() if not v <= limit]
            if got["num_pos"] != ref["num_pos"] or not math.isclose(
                    got["loss"], ref["loss"], rel_tol=1e-5):
                failing.append("{} {}: {}".format(text, key, line))
    families = []
    for text in ("1x2x1", "1x1x2"):
        for name in FAMILIES:
            want = one_families[name]["float32"]
            per_rank = [r["families"][name] for r in ranks[text]]
            got = per_rank[0]
            errors = [rel_l2(g, w) for g, w in zip(got["outputs"],
                                                    want["outputs"])]
            off = rows_apart(got["rows"], want["rows"])
            ties = [o[-1] for o in off]
            line = {"layout": text, "cfg": name, "output_errors": errors,
                    "rows_off": len(off), "rows_off_at_ties": ties,
                    "rows_off_detail": off[:8],
                    "ranks_equal": all(torch.equal(r["rows"], got["rows"])
                                       for r in per_rank),
                    "plain_equal": [r["plain_equal"] for r in per_rank],
                    "launches": [r["launches"] for r in per_rank]}
            families.append(line)
            if not (max(errors) <= MESH_OUTPUT_LIMIT and all(ties)
                    and line["ranks_equal"] and all(line["plain_equal"])
                    and all(r["launches"]["nms_rows"] == 1
                            and r["launches"]["nms_mask"] == 0
                            for r in per_rank)):
                failing.append("families {}".format(line))
    remat = []
    for text, rs in ranks.items():
        for key in MESH_REMAT_KEYS[text]:
            got = rs[0]["steps"][key + "_remat"]
            # SSD300's float32 against the same layout's step without
            # remat, RFBNet300's float64 against one process's
            ref = (rs[0]["steps"][key] if key == "ssd300_f32"
                   else one_steps[key])
            held = {**momentum_errors(got["momentum"], ref["momentum"]),
                    **stats_errors(got["stats"], ref["stats"])}
            line = {"layout": text, "case": key,
                    "held_to": ("same layout without remat"
                                if key == "ssd300_f32" else "one process"),
                    "limit": MESH_REMAT_LIMITS[key],
                    "max_held_error": max(held.values()),
                    "bit_equal_tensors": sum(v == 0 for v in held.values()),
                    "tensors": len(held), "loss": got["loss"],
                    "loss_held_to": ref["loss"],
                    "ranks": [{
                        "peak_step_bytes": r["steps"][key + "_remat"][
                            "peak_step_bytes"],
                        "peak_step_bytes_without_remat": r["steps"][key][
                            "peak_step_bytes"],
                        "halo_bytes_by_pass": r["steps"][key + "_remat"][
                            "halo_bytes_by_pass"],
                        "halo_bytes_by_pass_without_remat": r["steps"][key][
                            "halo_bytes_by_pass"],
                        "peak_step_bytes_without_remat_warm": r["steps"][
                            key + "_warm"]["peak_step_bytes"],
                        "ms": r["steps"][key + "_remat"]["ms"],
                        "ms_without_remat": r["steps"][key]["ms"],
                        "ms_without_remat_warm": r["steps"][key + "_warm"][
                            "ms"]}
                        for r in rs]}
            remat.append(line)
            sent = [r["halo_bytes_by_pass"] for r in line["ranks"]]
            if not (line["max_held_error"] <= line["limit"]
                    and got["num_pos"] == ref["num_pos"]
                    and all(s["recompute"] == s["forward"] for s in sent)):
                failing.append("remat {}".format(line))
    int8 = []
    tp = ranks["1x2x1"]
    for name in FAMILIES:
        want = one_families[name]["int8"]
        per_rank = [r["int8"][name] for r in tp]
        line = {"layout": "1x2x1", "cfg": name,
                "outputs_equal": [all(torch.equal(g, w) for g, w in zip(
                    r["outputs"], want["outputs"])) for r in per_rank],
                "rows_equal": [torch.equal(r["rows"], want["rows"])
                               for r in per_rank],
                "rows_kept": int((want["rows"][..., 0] > 0).sum()),
                "plain_equal": [r["plain_equal"] for r in per_rank],
                "launches": [r["launches"] for r in per_rank],
                "launches_world1": want["launches"],
                "int8_cache_bytes": [r["int8_cache_bytes"]
                                     for r in per_rank],
                "int8_cache_bytes_world1": want["int8_cache_bytes"]}
        line["int8_cache_share_of_world1"] = max(
            line["int8_cache_bytes"]) / max(want["int8_cache_bytes"], 1)
        int8.append(line)
        if not (all(line["outputs_equal"]) and all(line["rows_equal"])
                and all(line["plain_equal"]) and line["rows_kept"]
                and all(r == want["launches"] and r["int_mm"] > 0
                        and r["nms_rows"] == 1 for r in line["launches"])):
            failing.append("int8 {}".format(line))
    one_ssd = one_steps["ssd300_f32"]
    sp = ranks["1x1x2"]
    memory = {
        "world1_param_bytes": one_ssd["param_bytes"],
        "world1_momentum_bytes": one_ssd["momentum_bytes"],
        "m2_param_bytes": [r["steps"]["ssd300_f32"]["param_bytes"]
                           for r in tp],
        "m2_momentum_bytes": [r["steps"]["ssd300_f32"]["momentum_bytes"]
                              for r in tp],
        "world1_peak_step_bytes": one_ssd["peak_step_bytes"],
        "s2_peak_step_bytes": [r["steps"]["ssd300_f32"]["peak_step_bytes"]
                               for r in sp],
        "world1_activation_bytes": one_ssd["activation_bytes"],
        "s2_activation_bytes": [r["steps"]["ssd300_f32"]["activation_bytes"]
                                for r in sp],
        "s2_halo_bytes": [r["steps"]["ssd300_f32"]["halo_bytes"]
                          for r in sp],
        "world1_saved_bytes": one_ssd["saved_bytes"],
        "s2_saved_bytes": [r["steps"]["ssd300_f32"]["saved_bytes"]
                           for r in sp],
        "s2_halo_copy_bytes": [r["steps"]["ssd300_f32"]["halo_copy_bytes"]
                               for r in sp],
        "world1_ms": one_ssd["ms"]}
    share = max((p + m) / (one_ssd["param_bytes"] + one_ssd[
        "momentum_bytes"]) for p, m in zip(memory["m2_param_bytes"],
                                           memory["m2_momentum_bytes"]))
    memory["m2_share_of_world1"] = share
    memory["s2_peak_share_of_world1"] = max(
        memory["s2_peak_step_bytes"]) / max(one_ssd["peak_step_bytes"], 1)
    memory["s2_activation_share_of_world1"] = max(
        memory["s2_activation_bytes"]) / max(one_ssd["activation_bytes"], 1)
    memory["s2_saved_share_of_world1"] = max(
        memory["s2_saved_bytes"]) / max(one_ssd["saved_bytes"], 1)
    memory["s2_saved_less_copies_share_of_world1"] = max(
        s - c for s, c in zip(memory["s2_saved_bytes"],
                              memory["s2_halo_copy_bytes"])) / max(
        one_ssd["saved_bytes"], 1)
    if not share <= 0.65:
        failing.append("M = 2 keeps {:.3f} of the parameter and momentum "
                       "bytes".format(share))
    cli_train = tp[0]["cli_train"]
    cli_eval = sp[0]["cli_eval"]
    remat_train = sp[0]["remat_train"]
    eval_int8 = tp[0]["cli_eval_int8"]
    cli_line = {
        "train_mesh_model_2": {"losses": [
            {k: m[k] for k in ("step", "loss", "num_pos")}
            for m in cli_train["losses"]], "evals": cli_train["evals"],
            "ckpt_steps": cli_train["ckpt_steps"],
            "launches": [r["cli_train"]["launches"] for r in tp]},
        "eval_mesh_spatial_2": {"maps": cli_eval["maps"],
                                "images": cli_eval["images"],
                                "dropped": cli_eval["dropped"],
                                "launches": [r["cli_eval"]["launches"]
                                             for r in sp]},
        "eval_world1": {"maps": world1_eval["maps"],
                        "images": world1_eval["images"],
                        "dropped": world1_eval["dropped"],
                        "launches": world1_eval["launches"]},
        "train_yml_remat_mesh_spatial_2": {
            "losses": [{k: m[k] for k in ("step", "loss", "num_pos")}
                       for m in remat_train["losses"]],
            "evals": remat_train["evals"],
            "ckpt_steps": remat_train["ckpt_steps"],
            "halo_bytes_by_pass": [r["remat_train"]["halo_bytes_by_pass"]
                                   for r in sp],
            "launches": [r["remat_train"]["launches"] for r in sp]},
        "eval_int8_mesh_model_2": {
            "maps": eval_int8["maps"], "images": eval_int8["images"],
            "dropped": eval_int8["dropped"],
            "launches": [r["cli_eval_int8"]["launches"] for r in tp]},
        "eval_int8_world1": {"maps": world1_int8["maps"],
                             "images": world1_int8["images"],
                             "dropped": world1_int8["dropped"],
                             "launches": world1_int8["launches"]}}
    cli_line["remat_maps"] = {
        "validation_bf16_mesh_spatial_2": remat_train["evals"][-1]["mAP"],
        "eval_int8_mesh_model_2": eval_int8["maps"][0],
        "eval_int8_world1": world1_int8["maps"][0]}
    # int8 at M = 2 against world 1's int8, same checkpoint: bit-equal
    int8_apart = det_lines_apart(eval_int8["lines"], world1_int8["lines"],
                                 0.0, 0.0, 0.0)
    n_int8_lines = sum(len(v) for v in world1_int8["lines"].values())
    cli_line["eval_int8_lines"] = {
        "world1": n_int8_lines,
        "mesh_model_2": sum(len(v) for v in eval_int8["lines"].values()),
        "apart": len(int8_apart), "apart_detail": int8_apart[:8]}
    if remat_train["ckpt_steps"] != [4] or not all(
            math.isfinite(m["loss"]) and m["num_pos"] > 0
            for m in remat_train["losses"]) \
            or not eval_int8["images"] == world1_int8["images"] == n_test \
            or not n_int8_lines \
            or eval_int8["lines"] != world1_int8["lines"] \
            or eval_int8["maps"] != world1_int8["maps"] \
            or eval_int8["dropped"] != world1_int8["dropped"] \
            or not all(r["remat_train"]["halo_bytes_by_pass"]["recompute"]
                       > 0 for r in sp) \
            or not world1_int8["launches"]["int_mm"] > 0 \
            or world1_int8["launches"]["nms_rows"] != -(-n_test // 32) \
            or not all(r["cli_eval_int8"]["launches"]["int_mm"]
                       == world1_int8["launches"]["int_mm"]
                       and r["cli_eval_int8"]["launches"]["nms_rows"]
                       == -(-n_test // 32) for r in tp) \
            or not all(r["remat_train"]["launches"]["nms_rows"] == 1
                       for r in sp):
        failing.append("remat and int8 command lines {}".format({
            k: cli_line[k] for k in (
                "train_yml_remat_mesh_spatial_2", "eval_int8_mesh_model_2",
                "eval_int8_world1", "eval_int8_lines")}))
    maps = [cli_train["evals"][-1]["mAP"], cli_eval["maps"][0],
            world1_eval["maps"][0]]
    # the spatial mesh's detection files against world 1's, same weights
    apart = det_lines_apart(cli_eval["lines"], world1_eval["lines"])
    n_lines = sum(len(v) for v in world1_eval["lines"].values())
    cli_line["eval_lines"] = {
        "world1": n_lines,
        "mesh_spatial_2": sum(len(v) for v in cli_eval["lines"].values()),
        "apart": len(apart), "apart_at_ties": sum(a[-1] for a in apart),
        "apart_detail": apart[:8]}
    if cli_train["ckpt_steps"] != [4] or not all(
            math.isfinite(m["loss"]) and m["num_pos"] > 0
            for m in cli_train["losses"]) or not n_lines or not all(
                a[-1] for a in apart) or len(apart) > 0.01 * n_lines \
            or not cli_eval["images"] == world1_eval["images"] == n_test \
            or not math.isclose(maps[1], maps[2], abs_tol=1e-3):
        failing.append("command lines {}".format(cli_line))
    for r in tp:
        if r["cli_train"]["launches"]["nms_rows"] != 1:
            failing.append("train validation launches {}".format(
                r["cli_train"]["launches"]))
    for r in sp:
        if r["cli_eval"]["launches"]["nms_rows"] != 1:
            failing.append("eval launches {}".format(
                r["cli_eval"]["launches"]))
    seconds["phase"] = time.perf_counter() - t_start
    result = {"phase": "mesh", "backend": "gloo",
              "device": "cuda:0 (every rank)",
              "note": "ranks share one card on gloo: correctness and "
                      "memory, not scaling",
              "steps": steps, "f32_cause": f32_cause,
              "families": families, "remat": remat, "int8": int8,
              "memory": memory,
              "cli": cli_line, "maps": maps,
              "child_seconds": {t: [r["seconds"] for r in rs]
                                for t, rs in ranks.items()},
              "seconds": seconds, "nvidia_smi": power_limit()}
    emit(result)
    if failing:
        raise AssertionError("mesh phase: {}".format(failing[:20]))
    return result


def mesh_launches(mesh, name):
    """The ``mesh`` phase's launches of kernel entry ``name`` on each rank:
    every family's eval batch at (1, 2, 1) and (1, 1, 2), in int8 at
    (1, 2, 1), and the command lines' validations and evals."""
    out = {}
    for line in mesh["families"]:
        out["{} {}".format(line["layout"], line["cfg"])] = [
            launches[name] for launches in line["launches"]]
    for line in mesh["int8"]:
        out["{} int8 {}".format(line["layout"], line["cfg"])] = [
            launches[name] for launches in line["launches"]]
    cli_line = mesh["cli"]
    out["train --mesh_model 2"] = [
        launches[name] for launches in
        cli_line["train_mesh_model_2"]["launches"]]
    out["eval --mesh_spatial 2"] = [
        launches[name] for launches in
        cli_line["eval_mesh_spatial_2"]["launches"]]
    out["train --cfg remat_s2.yml"] = [
        launches[name] for launches in
        cli_line["train_yml_remat_mesh_spatial_2"]["launches"]]
    out["eval --mesh_model 2 --quant int8"] = [
        launches[name] for launches in
        cli_line["eval_int8_mesh_model_2"]["launches"]]
    return out


def main():
    if sys.argv[1:2] == ["--ddp_child"]:
        ddp_child(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--mesh_child"]:
        mesh_child(sys.argv[2:])
        return
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
    timed("topk", phase_topk)
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
    ddp = timed("ddp", phase_ddp)
    mesh = timed("mesh", phase_mesh)
    vis = timed("visualize", phase_visualize)
    debug, flags, demos = vis["debug"], vis["flags"], vis["demos"]
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
            "eval_dense": bf16["eval_dense"]["launches"][name],
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
                       for b, one in a["served"].items()},
            "ddp": ddp_launches(ddp, name),
            "mesh": mesh_launches(mesh, name),
            "train_debug": debug["launches"][name],
            "flags": {tag: flags[tag]["launches"][name]
                      for tag in ("off", "on")},
            "detect_img": demos["launches"]["detect_img"][name],
            "live": demos["launches"]["live"][name]}
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
                "serving_ssd300": bf16["bn_eval_launches"],
                "ddp": ddp_launches(ddp, "bn_eval"),
                "mesh": mesh_launches(mesh, "bn_eval"),
                "train_debug": debug["launches"]["bn_eval"],
                "flags": {tag: flags[tag]["launches"]["bn_eval"]
                          for tag in ("off", "on")}},
            "timed_on": "{} {}".format(largest["cfg"],
                                       largest["bn_eval"]["largest"]),
            **largest["bn_eval"]}
    # the norm's backward with respect to x, an entry of the same source:
    # no TPU kernel's port either (XLA fuses the gradient of flax's norm);
    # on the path of input-gradient saliency, python -m
    # odtpu_torch.train_debug; timed on RFBNet512's largest norm input
    timed_case = vis["bn_backward"][0]
    backward = {
        "name": "bn_eval_backward_dx", "route": "cuda",
        "source": "odtpu_torch/csrc/batch_norm.cu",
        "replaces": "the gradient of odtpu/models/common.py:177 flax "
                    "nn.BatchNorm in eval mode with respect to its input "
                    "(jax.grad, fused by XLA; no Pallas kernel)",
        "launches": debug["launches"]["bn_eval_backward_dx"],
        "path": "train_debug saliency on RFBNet300, {} sources".format(
            len(debug["norms_upstream_of_each_source"])),
        "launches_by_path": {
            "train_debug": debug["launches"]["bn_eval_backward_dx"],
            "flags": {tag: flags[tag]["launches"]["bn_eval_backward_dx"]
                      for tag in ("off", "on")}},
        "timed_on": timed_case["case"],
        **{k: timed_case[k] for k in ("ms", "device_ms", "plain_ms",
                                      "library_ms", "max_abs_err",
                                      "bound_ms", "bound_by", "bytes")},
        "note": "library_ms is autograd's backward of "
                "F.batch_norm(training=False) with respect to x"}
    emit({"kernels": [mask, rows, norm, backward], "host": [host],
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
