"""Spatial partitioning: every map split along H over the spatial group.

Counterpart of the halo exchanges that XLA inserts at each conv when
``odtpu`` shards its images' H axis over the mesh's "spatial" axis
(``odtpu/parallel/mesh.py:60`` ``image_sharding``).

- **One rule for the slabs** (:func:`slab`): a map of global height H
  gives spatial rank s the rows ``[s * c, (s + 1) * c)`` clipped to
  ``[0, H)``, ``c = ceil(H / S)``; the last ranks may hold fewer rows,
  or none (SSD300's 1-row map at S = 2). The image and every map follow
  it.
- **Each H-local op** (a conv whose kernel, stride or padding spans
  rows, a max pool, the bilinear upsample) computes its own output rows
  ``[o0, o1)`` of the op's global geometry. The input rows it needs,
  ``[o0 * stride - pad, (o1 - 1) * stride - pad + dilation * (k - 1) +
  1)``, are fetched from whichever ranks hold them (:class:`_Fetch`:
  only those rows, sent point to point), the part outside the map
  padded with zeros for a conv and -inf for a pool. A halo may be taller
  than a neighbour's slab (VGG's conv6, dilation 6, on a 19-row map at
  S = 4): it then comes from several ranks. The fetch's backward sends
  each halo row's gradient back to its owner, which adds it.
- **The heads** (:func:`gather_rows`): each source's loc and conf maps
  are gathered along H before they are flattened, so that the priors
  keep their global order; the backward keeps the rank's own rows.
- A rank that owns no rows of a map still takes part in every exchange
  of every layer, with empty tensors that stay in the autograd graph.

A slab does not know its map's global height. So the model's H-local
ops are recorded once, in order, from a forward of the unsharded model
on the ``meta`` device (:func:`record`, through ``models.shard_model``):
a :class:`Plan` of (op, global input height, global output height). A
sharded forward (:func:`sharded_forward`) takes the image's slab and
replays the plan: each op takes the next entry, checked against its kind
and its slab's height, and a forward that leaves an entry unused raises.
Without a plan in force every function here is the plain op.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from . import mesh


def slab(h: int, n: int, i: int) -> tuple[int, int]:
    """Rows ``[r0, r1)`` of a map of ``h`` rows that rank ``i`` of ``n``
    owns: ``ceil(h / n)`` a rank, in order, the last ones shorter or
    empty."""
    c = -(-h // n)
    return min(i * c, h), min((i + 1) * c, h)


def window(o0: int, o1: int, k: int, stride: int, pad: int,
           dilation: int) -> tuple[int, int]:
    """Input rows ``[lo, hi)`` (not clipped) that output rows ``[o0,
    o1)`` of an op of kernel ``k``, ``stride``, ``pad`` and ``dilation``
    read; (0, 0) for no output rows."""
    if o0 >= o1:
        return 0, 0
    return (o0 * stride - pad,
            (o1 - 1) * stride - pad + dilation * (k - 1) + 1)


@dataclass
class Plan:
    """The H-local ops of one forward, in order: (kind, global input
    height, global output height), for an image of ``image_h`` rows."""
    image_h: int
    ops: list = field(default_factory=list)


class _Replay:
    def __init__(self, plan: Plan):
        self.plan, self.cursor = plan, 0


# the plan being recorded (a Plan) or replayed (a _Replay), or None
_ACTIVE = None

# bytes this process has sent in row exchanges, by the pass that sent
# them: the forward's halos, their fetch again when ``TPU.REMAT``
# recomputes the forward inside the backward, and the backward's halo
# gradients; read and reset by callers that measure them
SENT = {"forward": 0, "recompute": 0, "backward": 0}
# the pass a forward's fetches count under (:func:`counted_as`)
_FORWARD_PASS = "forward"


@contextlib.contextmanager
def counted_as(name: str):
    """Count the forward's halo bytes in the block under ``SENT[name]``
    (``models.common.recomputing``: "recompute")."""
    global _FORWARD_PASS
    outer, _FORWARD_PASS = _FORWARD_PASS, name
    try:
        yield
    finally:
        _FORWARD_PASS = outer


@contextlib.contextmanager
def record(image_h: int):
    """Record the H-local ops of a forward of full maps into a
    :class:`Plan` (yielded)."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, Plan(image_h)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = outer


@contextlib.contextmanager
def replay(plan: Plan):
    """Run a forward of slabs under ``plan``; raises when it does not use
    every entry."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, _Replay(plan)
    try:
        yield
        if _ACTIVE.cursor != len(plan.ops):
            raise RuntimeError("a sharded forward used {} of its plan's {} "
                               "ops".format(_ACTIVE.cursor, len(plan.ops)))
    finally:
        _ACTIVE = outer


def replaying() -> bool:
    return isinstance(_ACTIVE, _Replay)


def _geometry(kind: str, x: Tensor, h_out: int | None = None):
    """The next plan entry of an op of ``kind`` on ``x``: while
    recording, note (kind, x's height, ``h_out``) and return None; while
    replaying, return the entry's (global input height, global output
    height), checked."""
    if isinstance(_ACTIVE, Plan):
        _ACTIVE.ops.append((kind, int(x.shape[2]), int(h_out)))
        return None
    ops = _ACTIVE.plan.ops
    if _ACTIVE.cursor >= len(ops):
        raise RuntimeError("a sharded forward ran more H-local ops than its "
                           "plan holds ({})".format(len(ops)))
    want, h_in, h_out = ops[_ACTIVE.cursor]
    _ACTIVE.cursor += 1
    m = mesh.current()
    r0, r1 = slab(h_in, m.spatial, m.s)
    if want != kind or x.shape[2] != r1 - r0:
        raise RuntimeError(
            "sharded forward off its plan at op {}: {} of {} rows (slab "
            "{}), got {} of {} rows".format(_ACTIVE.cursor - 1, want, h_in,
                                            r1 - r0, kind, x.shape[2]))
    return h_in, h_out


def _exchange(sends: dict, recvs: dict, like: Tensor, counted: str) -> dict:
    """Point-to-point within the spatial group: ``sends`` {spatial index:
    tensor}, ``recvs`` {spatial index: shape}; returns {spatial index:
    received tensor} on ``like``'s device and dtype. The bytes sent count
    under ``SENT[counted]``."""
    ranks = mesh.current().ranks("spatial")
    ops, bufs = [], {}
    for i, t in sends.items():
        ops.append(dist.P2POp(dist.isend, mesh.staged(t), ranks[i]))
        SENT[counted] += t.numel() * t.element_size()
    for i, shape in recvs.items():
        bufs[i] = torch.empty(shape, dtype=like.dtype,
                              device=mesh.staging_device(like))
        ops.append(dist.P2POp(dist.irecv, bufs[i], ranks[i]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {i: b.to(like.device) for i, b in bufs.items()}


def _rows(x: Tensor, lo: int, hi: int) -> Tensor:
    return x[:, :, lo:hi]


class _Fetch(torch.autograd.Function):
    """Global rows ``need[s]`` of a map of ``h`` rows on spatial rank s,
    from the slabs ``x`` of every rank (see :func:`fetch`)."""

    @staticmethod
    def forward(ctx, x, h, need):
        m = mesh.current()
        S, me = m.spatial, m.s
        r0, r1 = slab(h, S, me)
        a, b = need[me]
        # {rank: (lo, hi)} rows this rank sends to each, and takes from each
        out_rows, in_rows = {}, {}
        for t in range(S):
            t0, t1 = slab(h, S, t)
            lo, hi = max(need[t][0], r0), min(need[t][1], r1)
            if t != me and lo < hi:
                out_rows[t] = (lo, hi)
            lo, hi = max(a, t0), min(b, t1)
            if lo < hi:
                in_rows[t] = (lo, hi)
        shape = list(x.shape)
        recvs = {}
        for t, (lo, hi) in in_rows.items():
            if t != me:
                recvs[t] = shape[:2] + [hi - lo] + shape[3:]
        got = _exchange({t: _rows(x, lo - r0, hi - r0)
                         for t, (lo, hi) in out_rows.items()}, recvs, x,
                        _FORWARD_PASS)
        pieces = [_rows(x, lo - r0, hi - r0) if t == me else got[t]
                  for t, (lo, hi) in sorted(in_rows.items())]
        ctx.rows = (h, r0, out_rows, in_rows)
        if not pieces:
            return x.new_zeros(shape[:2] + [0] + shape[3:])
        return torch.cat(pieces, 2)

    @staticmethod
    def backward(ctx, grad):
        h, r0, out_rows, in_rows = ctx.rows
        me = mesh.current().s
        a = min((lo for lo, _ in in_rows.values()), default=0)
        shape = list(grad.shape)
        n = slab(h, mesh.current().spatial, me)
        dx = grad.new_zeros(shape[:2] + [n[1] - n[0]] + shape[3:])
        back = {t: _rows(grad, lo - a, hi - a)
                for t, (lo, hi) in in_rows.items() if t != me}
        got = _exchange(back, {t: shape[:2] + [hi - lo] + shape[3:]
                               for t, (lo, hi) in out_rows.items()}, grad,
                        "backward")
        if me in in_rows:
            lo, hi = in_rows[me]
            dx[:, :, lo - r0:hi - r0] += _rows(grad, lo - a, hi - a)
        for t in sorted(got):
            lo, hi = out_rows[t]
            dx[:, :, lo - r0:hi - r0] += got[t]
        return dx, None, None


def fetch(x: Tensor, h: int, need: list) -> Tensor:
    """The global rows ``need[s]`` (``[a, b)`` within ``[0, h)``) of a
    map of ``h`` rows on each spatial rank s, in order, from every rank's
    slab ``x``: each rank receives only the rows it lacks."""
    return _Fetch.apply(x, h, need)


def _needs(h_in: int, h_out: int, k: int, stride: int, pad: int,
           dilation: int) -> list:
    """Every spatial rank's window of an op, as (lo, hi) unclipped."""
    S = mesh.current().spatial
    return [window(*slab(h_out, S, t), k, stride, pad, dilation)
            for t in range(S)]


def _halo(x: Tensor, h_in: int, wins: list, fill: float) -> Tensor:
    """This rank's window ``wins[s]`` of the map of ``h_in`` rows whose
    slab is ``x``, the rows outside the map filled with ``fill``."""
    need = [(max(lo, 0), min(hi, h_in)) if lo < hi else (0, 0)
            for lo, hi in wins]
    need = [(a, b) if a < b else (0, 0) for a, b in need]
    lo, hi = wins[mesh.current().s]
    ext = fetch(x, h_in, need)
    a, b = need[mesh.current().s]
    top, bottom = a - lo, hi - b
    if b <= a:  # the window lies wholly in the padding
        top, bottom = hi - lo, 0
    if top or bottom:
        ext = F.pad(ext, (0, 0, top, bottom), value=fill)
    return ext


def _empty_like_out(x: Tensor, channels: int, width: int,
                    *deps: Tensor | None) -> Tensor:
    """An output slab of no rows that stays in the autograd graph of
    ``x`` and ``deps``, so that every rank runs the same backward."""
    out = x.new_zeros(x.shape[0], channels, 0, width)
    for t in (x,) + deps:
        if t is not None:
            out = out + t.sum() * 0
    return out


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d(x: Tensor, weight: Tensor, bias, stride, padding,
           dilation) -> Tensor:
    """``F.conv2d``, or under a replayed plan this rank's output rows of
    the conv of the full map (zero padding along H outside the map)."""
    (kh, kw), (sh, sw) = weight.shape[2:], _pair(stride)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)
    h_local = kh > 1 or sh > 1 or ph > 0
    if _ACTIVE is None or (not h_local and not replaying()):
        return F.conv2d(x, weight, bias, stride, padding, dilation)
    w_out = (x.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if not h_local:  # a row for a row: nothing to fetch
        if x.shape[2] == 0:
            return _empty_like_out(x, weight.shape[0], w_out, weight, bias)
        return F.conv2d(x, weight, bias, stride, padding, dilation)
    if not replaying():
        h_out = (x.shape[2] + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        _geometry("conv", x, h_out)
        return F.conv2d(x, weight, bias, stride, padding, dilation)
    h_in, h_out = _geometry("conv", x)
    wins = _needs(h_in, h_out, kh, sh, ph, dh)
    ext = _halo(x, h_in, wins, 0.0)
    lo, hi = wins[mesh.current().s]
    if lo >= hi:
        return _empty_like_out(ext, weight.shape[0], w_out, weight, bias)
    return F.conv2d(ext, weight, bias, (sh, sw), (0, pw), (dh, dw))


def max_pool2d(x: Tensor, k: int, stride: int, padding: int,
               ceil_mode: bool) -> Tensor:
    """``F.max_pool2d`` (square window), or under a replayed plan this
    rank's output rows of the pool of the full map (-inf outside it,
    the ceil-mode partial window at the global bottom only)."""
    if _ACTIVE is None:
        return F.max_pool2d(x, k, stride, padding, ceil_mode=ceil_mode)
    if not replaying():
        out = F.max_pool2d(x, k, stride, padding, ceil_mode=ceil_mode)
        _geometry("pool", x, out.shape[2])
        return out
    h_in, h_out = _geometry("pool", x)
    wins = _needs(h_in, h_out, k, stride, padding, 1)
    ext = _halo(x, h_in, wins, float("-inf"))
    lo, hi = wins[mesh.current().s]
    if lo >= hi:
        # the width of the full map's pool: its padding and ceil mode
        w_out = F.max_pool2d(torch.empty(1, 1, k, x.shape[3], device="meta"),
                             (k, k), (stride, stride), (0, padding),
                             ceil_mode=ceil_mode).shape[3]
        return _empty_like_out(ext, x.shape[1], w_out)
    # along H the window is exact (no partial window): W as the full pool
    return F.max_pool2d(ext, (k, k), (stride, stride), (0, padding),
                        ceil_mode=ceil_mode)


# (h_in, h_out, S) -> every spatial rank's input rows of a resize
_RESIZE_WINDOWS: dict = {}


def heights(x: Tensor, h_out: int) -> tuple[int, int]:
    """(global input height, global output height) of a resize of ``x``
    along H to ``h_out`` rows (a plan entry of its own: ``h_out`` is read
    only outside a replayed plan, where the caller's target is a slab)."""
    if _ACTIVE is None:
        return x.shape[2], h_out
    if not replaying():
        _geometry("resize", x, h_out)
        return x.shape[2], h_out
    return _geometry("resize", x)


def resize_input(x: Tensor, h_in: int, h_out: int,
                 w: Tensor) -> tuple[Tensor, Tensor]:
    """For a linear resize along H by ``w``, the [h_out, h_in] matrix over
    global rows: (the rows of ``w`` this rank's output takes, cut to the
    input rows they read; those input rows, fetched). Outside a replayed
    plan: (``w``, ``x``)."""
    if not replaying():
        return w, x
    S, me = mesh.current().spatial, mesh.current().s
    key = (h_in, h_out, S)
    if key not in _RESIZE_WINDOWS:  # read once from the host
        weigh = w.detach().abs().cpu()
        wins = []
        for t in range(S):
            o0, o1 = slab(h_out, S, t)
            cols = torch.nonzero(weigh[o0:o1].sum(0)).flatten().tolist()
            wins.append((cols[0], cols[-1] + 1) if cols else (0, 0))
        _RESIZE_WINDOWS[key] = wins
    wins = _RESIZE_WINDOWS[key]
    ext = fetch(x, h_in, wins)
    o0, o1 = slab(h_out, S, me)
    a, b = wins[me]
    return w[o0:o1, a:b], ext


class _GatherRows(torch.autograd.Function):
    """The spatial ranks' slabs of a map of ``h`` rows, concatenated along
    H; the backward keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, h):
        m = mesh.current()
        c = -(-h // m.spatial)
        r0, r1 = slab(h, m.spatial, m.s)
        ctx.rows = (r0, r1)
        pad = F.pad(x, (0, 0, 0, c - x.shape[2])) if x.shape[2] < c else x
        parts = mesh.all_gather(pad.contiguous(), "spatial")
        return torch.cat([p[:, :, :slab(h, m.spatial, t)[1]
                            - slab(h, m.spatial, t)[0]]
                          for t, p in enumerate(parts)], 2)

    @staticmethod
    def backward(ctx, grad):
        r0, r1 = ctx.rows
        return grad[:, :, r0:r1], None


def gather_rows(x: Tensor) -> Tensor:
    """The full map from every spatial rank's slab ``x`` (the heads'
    outputs); ``x`` itself outside a replayed plan."""
    if _ACTIVE is None:
        return x
    if not replaying():
        _geometry("gather", x, x.shape[2])
        return x
    h, _ = _geometry("gather", x)
    return _GatherRows.apply(x, h)


def sharded_forward(model, forward, images: Tensor, *args, **kwargs):
    """``forward(model, images, ...)`` of a model sharded along H: the
    NHWC ``images`` (the data index's full batch) cut to this rank's
    slab, the model's plan (``model.spatial_plan``) replayed."""
    plan = model.spatial_plan
    if images.shape[1] != plan.image_h:
        raise ValueError("the spatial plan is for {}-row images, got "
                         "{}".format(plan.image_h, images.shape[1]))
    m = mesh.current()
    r0, r1 = slab(images.shape[1], m.spatial, m.s)
    with replay(plan):
        return forward(model, images[:, r0:r1], *args, **kwargs)
