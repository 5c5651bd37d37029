"""The benchmark's arithmetic: published peaks, the least time of the
hand-written kernels' work, FLOPs of the reference model, and the
reading of a ``torch.profiler`` Chrome trace.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W.
"""

from __future__ import annotations

import heapq
import json
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import reference

PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float32 operations per (i, j) pair of the NMS overlap test: four
# max/min, two subtracts, two clamps, the intersection product, the
# union's add and subtract, the threshold product and two compares
OPS_PER_PAIR = 14
# bytes of one candidate of ``nms_rows``: its gathered box (16), its
# prior index (8) and score (4) read, its row (20) written
NMS_ROWS_BYTES_PER_CANDIDATE = 16 + 8 + 4 + 20

# the trace's categories of operations that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_ms(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the card could take: bytes over HBM's rate or
    operations over the unit's peak, whichever is longer."""
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / ops_per_s)


def forward_flops(cfg: dict) -> float:
    """FLOPs of one image's forward through the reference model, counted
    by ``FlopCounterMode`` on ``meta`` (convs as 2 x MACs)."""
    h, w = cfg["image_size"]
    model = reference.build(cfg)
    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        model(torch.empty(1, h, w, 3), reference.Ctx())
    return float(fc.get_total_flops())


def norm_inputs(cfg: dict, batch: int) -> list[tuple[int, ...]]:
    """The input shape of every batch norm of one forward at ``batch``,
    on ``meta``."""
    h, w = cfg["image_size"]
    model = reference.build(cfg)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
        for m in model.modules()
        if isinstance(m, reference.common.BatchNorm)]
    try:
        with torch.device("meta"):
            model(torch.empty(batch, h, w, 3), reference.Ctx())
    finally:
        for hk in hooks:
            hk.remove()
    return shapes


def bn_eval_least_ms(shape, dtype: str) -> float:
    """An eval-mode norm of ``shape`` (N, C, H, W): the activation read
    and written once and three float32 values a channel read; three
    float32 operations an element."""
    numel = math.prod(shape)
    nbytes = 2 * numel * DTYPE_BYTES[dtype] + 3 * 4 * shape[1]
    return least_ms(nbytes, 3 * numel, PEAK_F32_FLOP_PER_S)


@torch.no_grad()
def needed_pairs(boxes, scores, alive, iou_thresh: float,
                 conf_thresh: float) -> int:
    """Pairs (i, j) a greedy NMS must test on score-sorted sets [N, K]:
    i kept, j later and live (past the score threshold, not yet removed)
    at i's turn."""
    n, k = scores.shape
    inter, union = reference.common.overlaps(boxes, boxes)
    over = (inter > torch.tensor(iou_thresh, dtype=torch.float32,
                                 device=boxes.device) * union) & (union > 0)
    idx = torch.arange(k, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    kills = over & later & alive[:, :, None]
    first = torch.where(kills.any(1), kills.float().argmax(1),
                        torch.full_like(idx, k)[None].expand(n, k))
    live0 = scores > conf_thresh
    need = (alive[:, :, None] & later & live0[:, None, :]
            & (first[:, None, :] >= idx[None, :, None]))
    return int(need.sum())


def nms_rows_least_ms(sets: int, k: int, pairs: int) -> float:
    return least_ms(sets * k * NMS_ROWS_BYTES_PER_CANDIDATE,
                    pairs * OPS_PER_PAIR, PEAK_F32_FLOP_PER_S)


def read_trace(path: str) -> dict:
    """From a Chrome trace of ``torch.profiler``: the device's
    operations (kernels, copies and fills: name, start, end in
    microseconds), the host events, the window's length, the device's
    busy time (overlapping operations counted once) and its idle gaps."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                     for e in events
                     if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                 "user_annotation")]
    timed = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    if not kernels:
        return {"kernels": [], "busy_us": 0.0, "window_us": 0.0,
                "gaps": [], "host": host}
    busy, end, gaps = 0.0, -math.inf, []
    for a, b, _ in kernels:
        if a > end and end > -math.inf:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(b for _, b in timed) - min(a for a, _ in timed)
    return {"kernels": kernels, "busy_us": busy, "window_us": window,
            "gaps": gaps, "host": host}


def gap_owners(gaps, host) -> list[str]:
    """What the host was doing in each device gap: the shortest host
    event that holds the gap's middle, else "host: between calls" (one
    sweep over the events in time order)."""
    events = sorted(host)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    owners = ["host: between calls"] * len(gaps)
    active, j = [], 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(events) and events[j][0] <= mid:
            a, b, name = events[j]
            heapq.heappush(active, (b - a, b, name))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        if active:
            owners[i] = active[0][2]
    return owners


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, in seconds; the gaps from
    ``trace["host_gaps"]`` (a trace with the host's operations) where
    given."""
    by_op: dict = {}
    for a, b, name in trace["kernels"]:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    by_gap: dict = {}
    gaps, host = trace.get("host_gaps", (trace["gaps"], trace["host"]))
    for gap, owner in zip(gaps, gap_owners(gaps, host)):
        by_gap[owner] = by_gap.get(owner, 0.0) + (gap[1] - gap[0]) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def kernel_seconds(trace: dict, needle: str) -> tuple[float, int]:
    """Summed device seconds and launches of kernels whose name holds
    ``needle``."""
    hits = [(b - a) for a, b, name in trace["kernels"] if needle in name]
    return sum(hits) / 1e6, len(hits)
