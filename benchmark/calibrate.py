"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2 [--lr RATE] [--dtype DTYPE] \
        [--follow N] [--out FILE]

For each seed the program's outputs are judged as a run judges them
(``sound``); then the control: for a serve cell the program's own int8
path (``Detector(quant="int8")``), for a train cell the reference with
fp8 convs (``reference.common.fp8_fake_quant``) in the program's place;
for a train cell also the fault "half of the batch left out" (the
program's step on the first half of each batch). A serve cell's
detector, or a train cell's state, is built once and takes each seed's
weights by ``load_state_dict`` (a train state's momentum and step count
reset). One JSON line a reading on standard output, and in ``--out``.

Each reading also carries ``look``, what the numbers not compared read:
a serve cell's ``rows_missing`` (``compare.rows_missing`` against the
reference's own detection of its own forward, the worst batch); a train
cell's worst leaf of the first gradient (and its name), the name of the
change's worst leaf and the change's median leaf's gap, the share of the reference's mined negatives that this side's
first logits mine otherwise (``mined_apart``), and the gap that mining
alone makes: the reference's first gradient with the negatives mined
from this side's logits against its own (``mining_alone``, worst and
median leaf, both in float32).

``--lr`` and ``--dtype`` run a train cell at another learning rate or
compute dtype (the configuration and the program's config alike);
``--follow N`` instead follows the
program and the reference through N updates on each seed and prints
their losses.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, compare, serve, train, weights
from . import reference
from .reference import loss as ref_loss
from .reference import photometric
from .reference.common import fp8_fake_quant

BASE_SEED = 3_000_000_000


def emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out is not None:
        out.write(text + "\n")
        out.flush()


def serve_readings(cell, seeds, control_seeds, seconds, out,
                   sound=True) -> list:
    cfg, tr = cell["config"], cell["traffic"]
    runs = [("control", serve.build(cfg, seeds[0], "cuda", quant="int8")[0],
             seeds[:control_seeds])]
    if sound:
        runs.insert(0, ("sound", serve.build(cfg, seeds[0], "cuda")[0],
                        seeds))
    lines = []
    for mode, d, ss in runs:
        for seed in ss:
            sd = weights.make(reference.build(cfg), cfg,
                              serve.derive(seed, 0), "cuda")
            d.model.load_state_dict(sd)
            images = serve.make_images(cfg, tr, seed, "cuda")
            pick = serve.pick_batches(tr, seed)
            loop = serve.Loop(d, images, tr, "cuda", capture=pick)
            loop.run(batches=tr["warmup_batches"])
            lat, window = loop.run(seconds=seconds)
            look = []
            nums, _ = serve.check(cfg, sd, images, loop, pick, "cuda",
                                  look=look)
            del d.step.forward  # the capture, set on the instance
            lines.append({"cell": cell["name"], "mode": mode, "seed": seed,
                          "batches": len(lat), "numbers": nums,
                          "look": {"rows_missing": max(look)}})
            emit(lines[-1], out)
    return lines


def leaf_names(cfg: dict) -> list:
    return sorted(dict(reference.build(cfg).named_parameters()))


def worst_leaves(side: dict, ref: dict, names: list) -> dict:
    """The first gradient's worst leaf, the change's worst leaf (the
    one ``update_gap`` reads) and the change's median leaf."""
    keep = ref["grad"] >= 1e-3 * ref["grad"].median()
    grad = compare.leaf_gap(side["grad"], ref["grad"])
    change = torch.where(keep, compare.leaf_gap(side["change"],
                                                ref["change"]), 0.0)
    return {"grad_worst": float(grad.max()),
            "grad_worst_leaf": names[int(grad.argmax())],
            "change_worst_leaf": names[int(change.argmax())],
            "change_median": float(compare.leaf_gap(
                side["change"], ref["change"], keep).median())}


def mining_look(cfg: dict, sd: dict, batch, sides: dict, names: list,
                device) -> dict:
    """{mode: {"mined_apart", "mining_alone": {...}}} at the first
    update: the reference's forward once, its gradient with its own
    negatives and with each side's."""
    with reference.no_tf32():
        model = reference.build(cfg)
        model.load_state_dict({k: v.clone() for k, v in sd.items()},
                              assign=True)
        named = dict(model.named_parameters())
        params = [named[k] for k in names]
        pri = reference.model_priors(cfg).to(device)
        images, boxes, labels = (t.to(device) for t in batch(0))
        x = photometric.preprocess(
            images, photometric.draw(images.shape[0], 0, device),
            cfg["pixel_means"])
        loc, logits = model(x, reference.Ctx(train=True))
        loc_t, conf_t = ref_loss.match(boxes, labels, pri, cfg["variance"],
                                       cfg["overlap_thresh"])
        own = ref_loss.hard_negatives(logits, conf_t, cfg)

        def grad(neg):
            loss = ref_loss.multibox(loc, logits, loc_t, conf_t, cfg, neg)
            return train.leaf_norms(torch.autograd.grad(
                loss, params, retain_graph=True))

        base = grad(own)
        out = {}
        for mode, side_logits in sides.items():
            neg = ref_loss.hard_negatives(side_logits.to(device), conf_t,
                                          cfg)
            gap = compare.leaf_gap(grad(neg), base)
            i = int(gap.argmax())
            out[mode] = {
                "mined_apart": float((neg ^ own).sum()) / float(own.sum()),
                "mining_alone": {"grad_worst": float(gap[i]),
                                 "grad_worst_leaf": names[i],
                                 "grad_median": float(gap.median())}}
        return out


def train_readings(cell, seeds, control_seeds, out, sound=True) -> list:
    cfg, tr = cell["config"], cell["traffic"]
    state, step, _ = train.build(cfg, seeds[0], "cuda")
    n = tr["reference_steps"]
    half = tr["batch"] // 2
    names = leaf_names(cfg)
    lines = []
    for seed in seeds if sound else seeds[:control_seeds]:
        sd = weights.make(reference.build(cfg), cfg, serve.derive(seed, 0),
                          "cuda")
        images = serve.make_images(cfg, tr, seed, "cuda")
        boxes, labels = train.make_boxes(tr, seed, "cuda")

        def batch(i):
            k = i % tr["host_batches"]
            return images[k], boxes[k], labels[k]

        def half_batch(i):
            return tuple(t[:half] for t in batch(i))

        ref = train.reference_steps(cfg, sd, batch, n, "cuda")
        modes = [("sound", batch)] if sound else []
        if seed in seeds[:control_seeds]:
            modes.append(("fault_half_batch", half_batch))
        sides, mine = {}, []
        for mode, feed in modes:
            state.model.load_state_dict(sd)
            state.optimizer.state.clear()
            state.step = 0
            prog = train.program_steps(state, step, feed, cfg, sd, n)
            mine.append((mode, prog))
        if seed in seeds[:control_seeds]:
            mine.append(("control", train.reference_steps(
                cfg, sd, batch, n, "cuda", lowp=fp8_fake_quant)))
        for mode, side in mine:
            if mode != "fault_half_batch":
                sides[mode] = side["forward"][1]
        looks = mining_look(cfg, sd, batch, sides, names, "cuda")
        for mode, side in mine:
            look = worst_leaves(side, ref, names)
            look.update(looks.get(mode, {}))
            lines.append({"cell": cell["name"], "mode": mode, "seed": seed,
                          "numbers": compare.train_numbers(side, ref),
                          "look": look})
            emit(lines[-1], out)
    return lines


def follow(cell, seeds, n, out) -> list:
    """The program's and the reference's losses through ``n`` updates."""
    cfg, tr = cell["config"], cell["traffic"]
    state, step, _ = train.build(cfg, seeds[0], "cuda")
    lines = []
    for seed in seeds:
        sd = weights.make(reference.build(cfg), cfg, serve.derive(seed, 0),
                          "cuda")
        images = serve.make_images(cfg, tr, seed, "cuda")
        boxes, labels = train.make_boxes(tr, seed, "cuda")

        def batch(i):
            k = i % tr["host_batches"]
            return images[k], boxes[k], labels[k]

        state.model.load_state_dict(sd)
        state.optimizer.state.clear()
        state.step = 0
        prog = train.program_steps(state, step, batch, cfg, sd, n)
        ref = train.reference_steps(cfg, sd, batch, n, "cuda")
        lines.append({"cell": cell["name"], "mode": "follow", "seed": seed,
                      "lr": cfg["optimizer"]["lr"],
                      "dtype": cfg["compute_dtype"],
                      "program_losses": prog["losses"],
                      "reference_losses": ref["losses"]})
        emit(lines[-1], out)
    return lines


def variant(cell: dict, lr=None, dtype=None) -> dict:
    """The cell at another learning rate or compute dtype."""
    cfg = dict(cell["config"])
    changes = cfg["port_cfg_changes"] = dict(cfg["port_cfg_changes"])
    if lr is not None:
        cfg["optimizer"] = dict(cfg["optimizer"], lr=lr)
        changes["TRAIN.OPTIMIZER.LR"] = lr
    if dtype is not None:
        cfg["compute_dtype"] = changes["TPU.COMPUTE_DTYPE"] = dtype
    return dict(cell, config=cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=BASE_SEED)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--follow", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    cell = variant(cell, args.lr, args.dtype)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = open(args.out, "a") if args.out else None
    t0 = time.time()
    try:
        if args.follow:
            follow(cell, seeds, args.follow, out)
        elif cell["traffic"]["driver"] == "serve":
            serve_readings(cell, seeds, args.control_seeds, args.seconds,
                           out)
        else:
            train_readings(cell, seeds, args.control_seeds, out)
    finally:
        if out is not None:
            out.close()
    print("calibrate: {:.1f} s".format(time.time() - t0), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
