"""Exact two-level top-k with ``jax.lax.top_k``'s contract.

Counterpart of ``odtpu/ops/topk.py``: values descending and, among equal
values, the smaller index first. ``torch.topk`` does not promise that
tie rule, and the detect path's survivors-first compaction relies on
it, so each stage takes the prefix of a stable descending sort.

As ``odtpu`` does, the axis of n elements is split into G contiguous
groups: a top-k per group, then a top-k over the G*k survivors. That
sorts G rows of ~n/G and one of G*k in place of one row of n, and stays
exact, ties included:

- an element of the global top-k is in its own group's top-k (at most k
  winners exist, so at most k come from one group);
- ties go to the smaller index, and groups are contiguous index ranges,
  so each group keeps the copies a global select would keep, and the
  survivors' order is the original index order;
- the last group is padded with -inf at the global end: pads carry the
  largest indices and never win a tie.

G comes from ``odtpu``'s heuristic (:func:`num_groups`), or from the
``groups`` argument, or from the environment variable
``ODTPU_TOPK_GROUPS`` (0 means flat); below 4 groups, or where a group
would hold fewer than k elements, the select is one flat sort.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import Tensor

# odtpu's target group length for k = 200-sized selects (tuned on its
# hardware, kept as it is): G = 17 at P = 8,732
_TARGET_GROUP = 512


def num_groups(n: int, k: int, groups: int | None = None) -> int:
    """The group count G that :func:`top_k_exact` takes for ``n``
    elements and ``k`` winners: ``groups`` where given, else
    ``ODTPU_TOPK_GROUPS`` where set, else ``odtpu``'s heuristic. The
    select is flat when G < 4 or n < G*k."""
    if groups is None:
        env = os.environ.get("ODTPU_TOPK_GROUPS")
        if env is not None:
            groups = int(env)
        else:
            groups = max(1, round(n / max(2 * int(k) + 128, _TARGET_GROUP)))
    return int(groups)


def _sorted_prefix(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def top_k_exact(x: Tensor, k: int,
                groups: int | None = None) -> tuple[Tensor, Tensor]:
    """x [..., n] -> (values [..., k], int64 indices [..., k]), as
    ``lax.top_k(x, k)`` gives them; ``groups`` overrides the group count
    (:func:`num_groups`)."""
    n = x.shape[-1]
    k = int(k)
    g_count = num_groups(n, k, groups)
    if g_count < 4 or n < g_count * k:
        return _sorted_prefix(x, k)
    g = -(-n // g_count)
    lead = x.shape[:-1]
    xp = x.reshape(-1, n)
    if g_count * g > n:
        xp = F.pad(xp, (0, g_count * g - n), value=float("-inf"))
    v1, i1 = _sorted_prefix(xp.reshape(-1, g_count, g), k)  # [N, G, k]
    starts = torch.arange(g_count, dtype=i1.dtype, device=x.device) * g
    gidx = (i1 + starts[:, None]).reshape(-1, g_count * k)
    v2, i2 = _sorted_prefix(v1.reshape(-1, g_count * k), k)
    idx = torch.gather(gidx, 1, i2)
    return v2.reshape(*lead, k), idx.reshape(*lead, k)
