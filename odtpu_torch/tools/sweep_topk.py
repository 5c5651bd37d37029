"""Sweep the two-level top-k's group count: ``python -m
odtpu_torch.tools.sweep_topk``.

Counterpart of ``tools/sweep_topk.py``. At one ``[rows, n]`` shape of
seeded uniform scores it first pins ``ops.topk.top_k_exact`` at G in
4/12/24/47 against the flat stable sort (values and indices), then
times G = 0 (flat) and each G of the sweep, skipping a G that would
leave a group fewer than k elements: ``--chain`` calls whose both
outputs are consumed, ``--reps`` times, by CUDA events on a card (the
host's clock on the CPU); ms a call.

    python -m odtpu_torch.tools.sweep_topk [--rows 640] [--n 24564]
        [--k 200] [--chain 20] [--reps 3] [--device cuda]

``--rows`` is the candidate sets, B * (C - 1) (640 for a VOC batch of
32); ``--n`` the priors (24,564 for SSD512, 8,732 for SSD300).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.topk import num_groups, top_k_exact

GROUPS = (0, 4, 8, 12, 16, 24, 32, 47, 64, 96)
PINNED = (4, 12, 24, 47)


def scores(rows: int, n: int, device, seed: int = 0) -> torch.Tensor:
    """Seeded uniform float32 scores [rows, n] on ``device``."""
    x = np.random.RandomState(seed).rand(rows, n).astype(np.float32)
    return torch.from_numpy(x).to(device)


def exact(x: torch.Tensor, k: int, groups) -> bool:
    """Whether ``top_k_exact`` at each of ``groups`` gives the flat
    sort's values and indices on ``x``, bit for bit."""
    want = top_k_exact(x, k, groups=0)
    return all(all(torch.equal(a, b) for a, b in
                   zip(top_k_exact(x, k, groups=g), want))
               for g in groups)


def time_ms(x: torch.Tensor, k: int, groups: int, chain: int,
            reps: int) -> float:
    """Mean ms of one ``top_k_exact(x, k, groups)`` over ``reps`` runs of
    ``chain`` calls, each call's values and indices summed into a
    carry."""
    def run():
        acc = torch.zeros((), device=x.device)
        for _ in range(chain):
            v, i = top_k_exact(x, k, groups=groups)
            acc = acc + v[:, 0].sum() + i[:, 0].sum() * 1e-12
        return acc

    run()  # warm-up
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        total = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        total = 1e3 * (time.perf_counter() - t0)
    return total / reps / chain


def sweep(rows=640, n=24564, k=200, chain=20, reps=3, device="cuda",
          groups=GROUPS) -> dict:
    """The pin and the sweep at one shape: ``{"exact": bool, "chosen":
    the heuristic's G, "ms": {G: ms a call}}``; raises where the pin
    fails. The heuristic's G is timed too, where ``groups`` lacks it."""
    x = scores(rows, n, device)
    if not exact(x[:4], k, PINNED):
        raise AssertionError("top_k_exact at G in {} != the flat sort at "
                             "[{}, {}], k {}".format(PINNED, rows, n, k))
    chosen = num_groups(n, k)
    ms = {g: time_ms(x, k, g, chain, reps)
          for g in sorted(set(groups) | {chosen}) if g == 0 or n >= g * k}
    return {"rows": rows, "n": n, "k": k, "exact": True, "chosen": chosen,
            "ms": ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=640,
                   help="candidate sets (B * (C-1)); 640 = B32 VOC")
    p.add_argument("--n", type=int, default=24564,
                   help="prior count (24564 = SSD512, 8732 = SSD300)")
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    out = sweep(args.rows, args.n, args.k, args.chain, args.reps,
                args.device)
    print("exactness ok (values+indices vs the flat sort at G in "
          "{})".format("/".join(map(str, PINNED))))
    for g, ms in out["ms"].items():
        label = "flat sort" if g == 0 else "G={}".format(g)
        if g == out["chosen"]:
            label += " (default)"
        print("{:>16}: {:8.4f} ms/iter".format(label, ms), flush=True)
    return out


if __name__ == "__main__":
    main()
