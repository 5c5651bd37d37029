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
   graph (the device alone), ``wrapper_ms`` 200 calls of its wrapper;
   beside its plain twin and its bound.
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
Then the ``kernels`` line, and last ``{"ok": true, "device": ...}``,
printed only when every phase passed.
"""

import json
import os
import re
import sys
import time

import torch

from odtpu_torch import eval_step
from odtpu_torch.infer import Detector, power_limit, random_images
from odtpu_torch.models import probe_layer_dims
from odtpu_torch.ops import detect
from odtpu_torch.ops.boxes import decode
from odtpu_torch.ops.cuda import build, nms_kernel
from odtpu_torch.ops.priors import prior_factory
from odtpu_torch.utils.config import default_cfg

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
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


def phase_build():
    t0 = time.perf_counter()
    path, nvcc_s, log = build.build("nms_kernel", verbose=True)
    for name in nms_kernel._C_ARGS:
        nms_kernel._kernel(name)  # load and bind it now
    report = ptxas_report(log)
    emit({"phase": "build", "kernel": "nms_kernel",
          "nvcc_seconds": nvcc_s, "seconds": time.perf_counter() - t0,
          "library": path.name, "entries": report,
          "ptxas": [l.strip() for l in log.splitlines() if l.strip()]})
    missing = {"nms_mask", "nms_rows"} - {
        e for e, r in report.items() if "spill_stores" in r}
    if missing:
        raise AssertionError("no ptxas report (with spills) for "
                             "{}".format(sorted(missing)))
    return report


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
    """Equal bit for bit (NaN boxes included, -0.0 apart from 0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


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
        "plain_ms": rows_plain_ms,
        # the gathered boxes, the order and the scores read, rows written
        **bound(nk * (16 + 8 + 4 + 20), pairs),
        "ptxas": ptxas.get("nms_rows", {})}
    emit({"phase": "kernel", "cases_kept": cases,
          "entries": [mask, rows_result]})
    return mask, rows_result


def plain_rows(step, loc, conf):
    """The eval step's rows from the plain detect path: odtpu's lax path
    (ops.nms.nms_rows per set), no kernel."""
    decoded = decode(loc, step.priors[None], step.variances)
    dense = detect._finalize(detect._per_class_nms_reference(
        decoded, conf[..., 1:], step.conf_thresh, step.nms_thresh,
        step.top_k), step.top_k, False)
    return detect._compact(dense, step.rows_cap)


def reset_counts():
    nms_kernel.LAUNCHES = nms_kernel.MASK_LAUNCHES = 0
    nms_kernel.ROWS_LAUNCHES = 0


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


def phase_main_path(dtype, warmup=3, batches=20):
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    det = Detector(cfg, device="cuda", seed=0)
    step = det.step
    images = torch.from_numpy(
        random_images(BATCH, cfg.MODEL.IMAGE_SIZE, 0)).cuda()
    for _ in range(warmup):
        det(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the serving path: uint8 batches in, rows out
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(batches):
        out = det(images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != {"nms_mask": 0, "nms_rows": batches}:
        raise AssertionError("{} batches made NMS kernel launches {}; want "
                             "one nms_rows launch per batch".format(
                                 batches, launches))
    rows, dropped = out["rows"], out["dropped"]
    if rows.shape != (BATCH, 200, 6) or dropped.shape != (BATCH,):
        raise AssertionError("rows {} dropped {}".format(
            tuple(rows.shape), tuple(dropped.shape)))
    if not torch.isfinite(rows).all():
        raise AssertionError("non-finite rows")
    kept = int((rows[..., 0] > 0).sum())
    if kept == 0:
        raise AssertionError("no detections at all")

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

    result = {"phase": "main_path", "dtype": dtype, "batch": BATCH,
              "batches": batches, "images_per_s": BATCH * batches / seconds,
              "ms_per_batch": 1e3 * seconds / batches,
              "forward_ms": forward_ms, "detect_ms": detect_ms,
              "max_memory_allocated": peak,
              "nms_launches": sum(launches.values()),
              "launches": launches, "dense": dense,
              "kept_rows": kept, "dropped": int(dropped.sum()),
              "rows_equal_plain": True}
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
        # the forward on the card against the CPU's, same weights, 2 images
        # (loc within 1e-4 of its largest value, conf atol 1e-4: the sums
        # run in another order, in float32 on both with TF32 off)
        x = images[:2]
        with torch.inference_mode():
            cpu = Detector(cfg, device="cpu", seed=0).step.forward(x.cpu())
            card = det.step.forward(x)
        loc_err = (card[0].cpu() - cpu[0]).abs().max().item()
        conf_err = (card[1].cpu() - cpu[1]).abs().max().item()
        scale = cpu[0].abs().max().item()
        if not (loc_err <= 1e-4 * scale and conf_err <= 1e-4):
            raise AssertionError("card forward != CPU forward: loc err {} "
                                 "(scale {}), conf err {}".format(
                                     loc_err, scale, conf_err))
        result.update(cpu_loc_err=loc_err, cpu_loc_scale=scale,
                      cpu_conf_err=conf_err)
    emit(result)
    return result


def main():
    info, _ = phase_device()
    ptxas = phase_build()
    cfg = default_cfg()
    priors = torch.from_numpy(
        prior_factory(cfg)(probe_layer_dims(cfg))).cuda()
    mask, rows = phase_kernel(priors, ptxas)
    bf16 = phase_main_path("bfloat16")
    phase_main_path("float32")
    # each entry's count from the run of the path that reaches it, in
    # bfloat16: the serving path for nms_rows, DetectOut for nms_mask
    mask["launches"] = bf16["dense"]["launches"]["nms_mask"]
    mask["path"] = "DetectOut (dense contract), {} calls".format(
        bf16["dense"]["calls"])
    rows["launches"] = bf16["launches"]["nms_rows"]
    rows["path"] = "Detector (serving), {} batches".format(bf16["batches"])
    emit({"kernels": [mask, rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    sys.stdout.flush()
    sys.stderr.flush()
    # nothing may follow the last line: skip interpreter teardown, where
    # an atexit hook or a late warning could still print
    os._exit(0)


if __name__ == "__main__":
    main()
