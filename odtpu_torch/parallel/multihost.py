"""Gathering the ranks' host-side results.

Counterpart of ``odtpu/parallel/multihost.py``: each rank evaluates its
slice of the test set with no collective inside the loop, and at the end
the detection rows are all-gathered once, so that every rank scores the
same global mAP (``eval.evaluator``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import collective_device, world


def allgather_host_rows(rows: np.ndarray) -> np.ndarray:
    """All-gather this rank's ``[N_r, K]`` float32 rows; returns their
    concatenation in rank order, ``[sum N_r, K]``.

    The counts may differ, 0 included: they are exchanged first and
    every rank's rows are padded to the largest count for the
    collective, then cut back. One process: ``rows`` as they are.
    """
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2:
        raise ValueError("expected [N, K] rows, got shape {}".format(
            rows.shape))
    w = world()
    if w == 1:
        return rows
    dev = collective_device()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(w)]
    dist.all_gather(counts, torch.tensor([rows.shape[0]], device=dev))
    counts = [int(c) for c in counts]
    m = max(counts)
    if m == 0:
        return rows[:0]
    padded = np.zeros((m, rows.shape[1]), np.float32)
    padded[:rows.shape[0]] = rows
    parts = [torch.empty(m, rows.shape[1], device=dev) for _ in range(w)]
    dist.all_gather(parts, torch.from_numpy(padded).to(dev))
    return np.concatenate([p[:c].cpu().numpy()
                           for p, c in zip(parts, counts)], axis=0)


def sum_over_ranks(*values: int) -> tuple[int, ...]:
    """Integer counts summed over the ranks (themselves in one process)."""
    if world() == 1:
        return tuple(int(v) for v in values)
    t = torch.tensor(values, dtype=torch.int64, device=collective_device())
    dist.all_reduce(t)
    return tuple(int(v) for v in t.tolist())
