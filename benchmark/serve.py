"""Serve cells: closed-loop batches through the program's serving entry,
``odtpu_torch.infer.Detector.__call__`` (the copy to the card, the
forward, decode, per-class top-k, NMS and the cross-class rows), with
the rows and ``dropped`` copied back to the host.

The traffic's parameters: ``batch`` images a batch from ``host_batches``
distinct pinned host batches used in turn, ``in_flight`` batches in
flight (batch i + 1 is submitted before batch i's rows are awaited),
``warmup_batches`` before the window, ``check_batches`` of the distinct
batches compared with the reference after it, ``profile_batches`` under
the profiler in a ``--trace 1`` run.
"""

from __future__ import annotations

import gc
import statistics
import time
from collections import deque

import torch

from . import compare, reference, trace, weights, yardstick
from .cells import port_cfg
from .reference.detect import detect


def derive(seed: int, stream: int) -> int:
    """A generator seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def make_images(cfg: dict, tr: dict, seed: int, device) -> list:
    """``host_batches`` uint8 BGR batches [B, H, W, 3] drawn on ``device``
    from the seed, in pinned host memory."""
    h, w = cfg["image_size"]
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 1))
    x = torch.randint(0, 256, (tr["host_batches"], tr["batch"], h, w, 3),
                      dtype=torch.uint8, generator=g, device=device).cpu()
    if torch.device(device).type == "cuda":
        x = x.pin_memory()
    return list(x.unbind(0))


def build(cfg: dict, seed: int, device, quant=None):
    """(the program's detector with the benchmark's weights, the weights:
    {name: float32 tensor on ``device``})."""
    from odtpu_torch.infer import Detector
    sd = weights.make(reference.build(cfg), cfg, derive(seed, 0), device)
    return Detector(port_cfg(cfg), state_dict=sd, device=device,
                    quant=quant), sd


class Loop:
    """The closed loop: ``detector(images)`` with ``in_flight`` batches
    in flight; each batch's rows and ``dropped`` land in pinned host
    buffers, and the host waits for the oldest batch's copy. For the
    host batches in ``capture`` the forward's outputs of each call are
    kept (``captured``, by host batch; the last call's, as ``latest``
    keeps its rows)."""

    def __init__(self, detector, images: list, tr: dict, device,
                 capture=()):
        self.det, self.images, self.tr = detector, images, tr
        self.cuda = torch.device(device).type == "cuda"
        self.next = 0
        self.latest = {}  # host batch -> (rows, dropped) of its last run
        self.captured = {}  # host batch -> forward outputs of its last run
        self._capture, self._current = set(capture), None
        n = tr["in_flight"] + 1
        rows = (tr["batch"], int(detector.step.rows_cap), 6)
        self.slots = [(torch.empty(rows, pin_memory=self.cuda),
                       torch.empty(tr["batch"], dtype=torch.int32,
                                   pin_memory=self.cuda)) for _ in range(n)]
        if self._capture:
            forward = detector.step.forward

            def kept(images):
                out = forward(images)
                if self._current is not None:
                    self.captured[self._current] = out
                return out

            detector.step.forward = kept

    def _submit(self):
        i = self.next
        self.next += 1
        k = i % len(self.images)
        self._current = k if k in self._capture else None
        t = time.perf_counter()
        out = self.det(self.images[k])
        rows, dropped = self.slots[i % len(self.slots)]
        rows.copy_(out["rows"], non_blocking=True)
        dropped.copy_(out["dropped"], non_blocking=True)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        return i, t, event

    def _finish(self, pending) -> tuple[float, float]:
        i, t, event = pending.popleft()
        if event is not None:
            event.synchronize()
        done = time.perf_counter()
        rows, dropped = self.slots[i % len(self.slots)]
        self.latest[i % len(self.images)] = (rows.clone(), dropped.clone())
        return done - t, done

    def run(self, seconds: float | None = None, batches: int | None = None):
        """Until ``seconds`` have passed (the batch that crosses the
        deadline counts) or ``batches`` have completed; then the batches
        still in flight are awaited, uncounted. Returns (latencies in s,
        the window in s)."""
        pending, lat = deque(), []
        t0 = time.perf_counter()
        done = t0
        while True:
            pending.append(self._submit())
            if len(pending) < self.tr["in_flight"]:
                continue
            wait, done = self._finish(pending)
            lat.append(wait)
            if seconds is not None and done - t0 >= seconds:
                break
            if batches is not None and len(lat) >= batches:
                break
        while pending:
            self._finish(pending)
        return lat, done - t0


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, n = 20, the
    'exclusive' method); a single value is its own."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[-1]


@torch.no_grad()
def check(cfg: dict, sd: dict, images: list, loop: Loop, pick, device,
          pairs: bool = False, look: list | None = None
          ) -> tuple[dict, float | None]:
    """The worst of each serving number (``compare``) over the
    ``pick``ed host batches, from their last call's forward outputs and
    rows; the reference in float32 with TF32 off, its forward in blocks
    of 8 images. With ``pairs``, also the least time of one ``nms_rows``
    launch on these batches' candidate sets (ms). With a ``look`` list,
    each batch's ``compare.rows_missing`` against the reference's own
    detection of its own forward is appended to it."""
    with reference.no_tf32():
        model = reference.build(cfg)
        model.load_state_dict(sd, assign=True)
        pri = reference.model_priors(cfg).to(device)
        means = torch.tensor([float(m) for m in cfg["pixel_means"]],
                             device=device)
        worst = dict.fromkeys(compare.SERVE_NUMBERS, 0.0)
        least = []
        for idx in pick:
            x = images[idx].to(device)
            locs, confs = [], []
            for blk in x.split(8):
                loc, logits = model((blk.float() - means).flip(-1),
                                    reference.Ctx())
                locs.append(loc)
                confs.append(torch.softmax(logits, -1))
            ref_out = (torch.cat(locs), torch.cat(confs))
            out = loop.captured[idx]
            rows, dropped = loop.latest[idx]
            ref = detect(out[0].float(), out[1].float(), pri, cfg)
            nums = {"forward_error": compare.forward_error(out, ref_out,
                                                           probs=True),
                    "detect_mismatch": compare.detect_mismatch(
                        rows.to(device), dropped.to(device), ref["rows"],
                        ref["dropped"])}
            worst = {k: max(worst[k], nums[k]) for k in worst}
            if look is not None:
                own = detect(ref_out[0], ref_out[1], pri, cfg)
                look.append(compare.rows_missing(rows.to(device),
                                                 own["rows"]))
            if pairs:
                k = ref["cand_scores"].shape[-1]
                n_pairs = yardstick.needed_pairs(
                    ref["cand_boxes"].reshape(-1, k, 4),
                    ref["cand_scores"].reshape(-1, k),
                    ref["alive"].reshape(-1, k), cfg["nms_thresh"],
                    cfg["conf_thresh"])
                least.append(yardstick.nms_rows_least_ms(
                    ref["alive"].reshape(-1, k).shape[0], k, n_pairs))
        return worst, (sum(least) / len(least) if least else None)


def pick_batches(tr: dict, seed: int) -> list:
    """The host batches to compare, drawn from the seed; each runs many
    times in a window, and its last run is compared."""
    g = torch.Generator().manual_seed(derive(seed, 2))
    order = torch.randperm(tr["host_batches"], generator=g).tolist()
    return sorted(order[:tr["check_batches"]])


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    cfg, tr = cell["config"], cell["traffic"]
    det, sd = build(cfg, seed, device)
    images = make_images(cfg, tr, seed, device)
    pick = pick_batches(tr, seed)
    loop = Loop(det, images, tr, device, capture=pick)
    spans = trace.Spans() if traced else None
    if traced:
        spans.wrap(det.step, "forward", "forward")
        spans.wrap(det.step, "detect", "detect")
    loop.run(batches=tr["warmup_batches"])
    if traced:
        spans.reset()
    setup_s = time.time() - t_start
    lat, window = loop.run(seconds=seconds)
    images_per_s = len(lat) * tr["batch"] / window
    out = {"attempted": len(lat), "failed": 0,
           "e2e": {"setup_s": setup_s, "serve_images_per_s": images_per_s}}
    t = time.time()
    if traced:
        out["spans_ms"] = spans.mean_ms()

        def more():
            first = loop.next
            loop.run(batches=tr["profile_batches"])
            return loop.next - first

        out["trace"] = trace.profiled(more, cell["name"])
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if loop.cuda else None)
    out["timings"] = {"setup_s": setup_s, "window_s": window,
                      "trace_s": time.time() - t}
    t = time.time()
    del det
    loop.det = None
    gc.collect()  # the capture ties the detector into a cycle
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"], nms_least = check(cfg, sd, images, loop, pick, device,
                                      pairs=traced)
    out["timings"]["check_s"] = time.time() - t
    if traced:
        out["ctx"] = {
            "spans_ms": out.pop("spans_ms"),
            "trace": out["trace"], "images_per_s": images_per_s,
            "iteration_s": window / len(lat),
            "batch_p95_ms": 1e3 * p95(lat),
            "flops_per_image": yardstick.forward_flops(cfg),
            "nms_rows_least_ms": nms_least,
            "bn_eval_least_ms": [yardstick.bn_eval_least_ms(
                s, cfg["compute_dtype"])
                for s in yardstick.norm_inputs(cfg, tr["batch"])]}
    return out
