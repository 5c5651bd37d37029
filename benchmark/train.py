"""Train cells: updates through the program's train step,
``odtpu_torch.train_step.TrainStep.__call__`` (the copy to the card, the
device photometric distortion, the forward, the loss with matching and
hard-negative mining, the backward, the clip and the SGD update).

The traffic's parameters: ``batch`` images an update from
``host_batches`` distinct pinned host batches used in turn, each image
with 1 to len(``boxes_per_image_pmf``) ground-truth boxes (the counts a
fixed multiset from the pmf, shuffled by the seed; sides uniform in
``box_side``, labels uniform over ``classes``); ``reference_steps``
updates on distinct batches that the reference follows, then
``warmup_steps`` more, then the window; ``profile_steps`` under the
profiler in a ``--trace 1`` run.

The reference follows the same object's first updates, from the same
weights and batches: each update's loss, the first gradient as the
optimizer got it (its momentum after one update, less the weight
decay) and each leaf's change after the compared updates.
"""

from __future__ import annotations

import time

import torch

from . import compare, reference, trace, weights, yardstick
from .cells import port_cfg
from .reference import loss as ref_loss
from .reference import photometric, sgd
from .serve import derive, make_images


def make_boxes(tr: dict, seed: int, device) -> tuple:
    """Pinned host boxes [N, B, G, 4] (point form, in [0, 1]) and labels
    [N, B, G] (-1 pads), G = len(pmf)."""
    pmf = tr["boxes_per_image_pmf"]
    n, b, gmax = tr["host_batches"], tr["batch"], len(pmf)
    total = n * b
    counts = [round(p * total) for p in pmf]
    counts[0] += total - sum(counts)
    per_image = torch.cat([torch.full((c,), k + 1)
                           for k, c in enumerate(counts)])
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 3))
    per_image = per_image.to(device)[torch.randperm(
        total, generator=g, device=device)].view(n, b)
    lo, hi = tr["box_side"]
    ctr = torch.rand(n, b, gmax, 2, generator=g, device=device)
    side = lo + (hi - lo) * torch.rand(n, b, gmax, 2, generator=g,
                                       device=device)
    boxes = torch.cat([ctr - side / 2, ctr + side / 2], -1).clamp(0.0, 1.0)
    labels = torch.randint(0, tr["classes"], (n, b, gmax), generator=g,
                           device=device)
    valid = torch.arange(gmax, device=device) < per_image[..., None]
    boxes = torch.where(valid[..., None], boxes, 0.0)
    labels = torch.where(valid, labels, -1)
    pin = torch.device(device).type == "cuda"
    boxes, labels = boxes.cpu(), labels.cpu()
    if pin:
        boxes, labels = boxes.pin_memory(), labels.pin_memory()
    return boxes, labels


def build(cfg: dict, seed: int, device):
    """(train state with the benchmark's weights, its step, the weights)."""
    from odtpu_torch.train_step import create_train_state, make_train_step
    sd = weights.make(reference.build(cfg), cfg, derive(seed, 0), device)
    port = port_cfg(cfg)
    state, priors = create_train_state(port, device, seed=derive(seed, 0))
    state.model.load_state_dict(sd)
    return state, make_train_step(priors, port), sd


@torch.no_grad()
def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(list(tensors))).double().cpu()


def program_steps(state, step, batches, cfg: dict, sd: dict,
                  n: int) -> dict:
    """The first ``n`` updates: each update's ``losses``, the first
    update's ``forward`` outputs (kept from the step's own call), the
    per-leaf norms of the first gradient as the optimizer got it
    (``grad``) and of each leaf's ``change`` after the ``n``; leaves in
    the order of their sorted names."""
    named = dict(state.model.named_parameters())
    names = sorted(named)
    params = [named[k] for k in names]
    wd = float(cfg["optimizer"]["weight_decay"])
    losses, grad, kept = [], None, []
    forward = step.forward

    def keep(*args, **kwargs):
        out = forward(*args, **kwargs)
        kept.append(tuple(t.detach() for t in out))
        return out

    for i in range(n):
        step.forward = keep if i == 0 else forward
        try:
            m = step(state, *batches(i))
        finally:
            step.forward = forward
        losses.append(m["loss"])
        if i == 0:
            # a leaf with no momentum has had no update: no gradient
            bufs = [state.optimizer.state.get(p, {}).get("momentum_buffer")
                    for p in params]
            grad = leaf_norms(torch.zeros_like(sd[k]) if b is None
                              else b - wd * sd[k]
                              for b, k in zip(bufs, names))
    change = leaf_norms(p.detach() - sd[k] for p, k in zip(params, names))
    return {"losses": [float(v) for v in torch.stack(losses).cpu()],
            "forward": kept[0], "grad": grad, "change": change}


def reference_steps(cfg: dict, sd: dict, batches, n: int, device,
                    lowp=None):
    """The reference's ``n`` updates from the same weights and batches,
    as :func:`program_steps` gives the program's."""
    with reference.no_tf32():
        model = reference.build(cfg)
        model.load_state_dict({k: v.clone() for k, v in sd.items()},
                              assign=True)
        named = dict(model.named_parameters())
        params = {k: named[k] for k in sorted(named)}
        pri = reference.model_priors(cfg).to(device)
        opt = cfg["optimizer"]
        bufs, losses, grad, first = {}, [], None, None
        for i in range(n):
            images, boxes, labels = batches(i)
            images, boxes, labels = (t.to(device)
                                     for t in (images, boxes, labels))
            x = photometric.preprocess(
                images, photometric.draw(images.shape[0], i, device),
                cfg["pixel_means"])
            loc, logits = model(x, reference.Ctx(train=True, lowp=lowp))
            loc_t, conf_t = ref_loss.match(boxes, labels, pri,
                                           cfg["variance"],
                                           cfg["overlap_thresh"])
            loss = ref_loss.multibox(loc, logits, loc_t, conf_t, cfg)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if i == 0:
                grad = leaf_norms(grads.values())
                first = (loc.detach(), logits.detach())
            sgd.step(params, grads, bufs, opt["lr"], opt["momentum"],
                     opt["weight_decay"])
            del loc, logits, loss, grads
        change = leaf_norms(p.detach() - sd[k] for k, p in params.items())
        return {"losses": losses, "forward": first, "grad": grad,
                "change": change}


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    cfg, tr = cell["config"], cell["traffic"]
    state, step, sd = build(cfg, seed, device)
    images = make_images(cfg, tr, seed, device)
    boxes, labels = make_boxes(tr, seed, device)
    cuda = torch.device(device).type == "cuda"

    def batch(i):
        k = i % tr["host_batches"]
        return images[k], boxes[k], labels[k]

    spans = trace.Spans() if traced else None
    if traced:
        for method in ("augment", "forward", "loss", "backward", "update"):
            spans.wrap(step, method, method)
    n_ref = tr["reference_steps"]
    prog = program_steps(state, step, batch, cfg, sd, n_ref)
    for i in range(n_ref, n_ref + tr["warmup_steps"]):
        step(state, *batch(i))
    if cuda:
        torch.cuda.synchronize()
    if traced:
        spans.reset()
    setup_s = time.time() - t_start
    i = n_ref + tr["warmup_steps"]
    losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(step(state, *batch(i))["loss"])
        i += 1
    if cuda:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rate = len(losses) * tr["batch"] / window
    out = {"attempted": len(losses),
           "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
           "e2e": {"setup_s": setup_s, "train_images_per_s": rate}}
    t = time.time()
    if traced:
        out["ctx"] = {"spans_ms": spans.mean_ms(),
                      "images_per_s": rate,
                      "iteration_s": window / len(losses),
                      "flops_per_image": 3 * yardstick.forward_flops(cfg)}

        def more():
            for j in range(i, i + tr["profile_steps"]):
                step(state, *batch(j))
            return tr["profile_steps"]

        out["trace"] = out["ctx"]["trace"] = trace.profiled(more,
                                                            cell["name"])
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else None)
    out["timings"] = {"setup_s": setup_s, "window_s": window,
                      "trace_s": time.time() - t}
    t = time.time()
    del state, step, losses
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(cfg, sd, batch, n_ref, device)
    out["numbers"] = compare.train_numbers(prog, ref)
    out["timings"]["check_s"] = time.time() - t
    return out
