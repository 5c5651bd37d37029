"""Greedy NMS: the CUDA kernel's two entries, their plain twins, and the
per-class NMS around them.

Counterpart of ``odtpu/ops/pallas/nms_kernel.py``. The kernel
(``csrc/nms_kernel.cu``) replaces the Pallas kernel ``_nms_kernel``:
:func:`nms_mask_cuda` has its contract (an alive mask), and
:func:`nms_rows_cuda` also gathers the candidates and writes the rows.
:func:`nms_mask_plain` and :func:`nms_rows_plain` compute the same in
plain torch with the same division-free test, and :func:`per_class_nms`
mirrors ``per_class_nms_pallas``.

A CUDA tensor goes to the kernel and a CPU tensor to the plain version.
There is no fallback: a CUDA input the kernel cannot take raises. The
serving path's entry is also the registered op ``odtpu::nms_rows``
(:func:`nms_rows`), which ``torch.export`` traces as one node.

The division-free test ``inter > thresh * union & union > 0`` rounds
once (a multiply) where ``odtpu.ops.nms`` rounds once in a divide, so a
pair within 1 ulp of the threshold could in principle decide differently
from :func:`odtpu_torch.ops.nms._greedy_mask`; the Pallas kernel has the
same caveat (``nms_kernel.py:84-93``).
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..topk import top_k_exact
from . import build

# kernel launches in this process, of either entry and of each; read
# and reset by callers that need to show a run went through the kernels
LAUNCHES = 0
MASK_LAUNCHES = 0
ROWS_LAUNCHES = 0

MAX_K = 1024  # the kill matrix fills shared memory at K = 1024

_C_ARGS = {
    # boxes, scores, alive, n, k, iou, score_thresh, stream
    "odtpu_nms_mask": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    # decoded, order, scores, rows, n, k, cf, p, ld_order, ld_scores,
    # iou, score_thresh, stream
    "odtpu_nms_rows": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_int64] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}
_FN: dict = {}


def _kernel(name: str):
    """The C entry ``name`` of the built library, bound with its types."""
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(build.load("nms_kernel"), name)
        fn.argtypes = _C_ARGS[name]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


def _check(boxes: Tensor, scores: Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2 \
            or boxes.shape[:2] != scores.shape:
        raise ValueError("want boxes [N, K, 4] and scores [N, K], got {} "
                         "and {}".format(tuple(boxes.shape),
                                         tuple(scores.shape)))
    if boxes.device != scores.device:
        raise ValueError("boxes on {} but scores on {}".format(
            boxes.device, scores.device))


def _check_rows(decoded: Tensor, order: Tensor, top_scores: Tensor,
                cf: int) -> None:
    if decoded.dim() != 3 or decoded.shape[-1] != 4 or order.dim() != 2 \
            or order.shape != top_scores.shape \
            or order.shape[0] != decoded.shape[0] * cf:
        raise ValueError(
            "want decoded [B, P, 4], order and top_scores [B*Cf, K] with "
            "Cf = {}, got {}, {} and {}".format(
                cf, tuple(decoded.shape), tuple(order.shape),
                tuple(top_scores.shape)))
    if not decoded.device == order.device == top_scores.device:
        raise ValueError("decoded, order and top_scores on {}, {} and {}"
                         .format(decoded.device, order.device,
                                 top_scores.device))
    if not decoded.is_contiguous() or order.stride(-1) != 1 \
            or top_scores.stride(-1) != 1:
        raise ValueError("decoded must be contiguous, and order and "
                         "top_scores contiguous along K")


def _check_cuda(name: str, k: int, *tensors: Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError("{} takes CUDA tensors, got {}".format(
            name, [str(t.device) for t in tensors]))
    if k > MAX_K:
        raise ValueError("K = {} candidates per set; the kernel takes at "
                         "most {}".format(k, MAX_K))


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
            name, err))


def nms_mask_cuda(boxes: Tensor, scores: Tensor, iou_thresh: float,
                  score_thresh: float = 0.0) -> Tensor:
    """[N, K, 4] score-sorted point-form boxes, [N, K] scores -> bool
    [N, K] alive mask, computed by the CUDA kernel on the current stream."""
    global LAUNCHES, MASK_LAUNCHES
    _check(boxes, scores)
    n, k = scores.shape
    _check_cuda("nms_mask_cuda", k, boxes, scores)
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("want float32 boxes and scores, got {} and {}"
                        .format(boxes.dtype, scores.dtype))
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary")
    alive = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n and k:
        _launched(_kernel("odtpu_nms_mask")(
            boxes.data_ptr(), scores.data_ptr(), alive.data_ptr(), n, k,
            float(iou_thresh), float(score_thresh),
            torch.cuda.current_stream(boxes.device).cuda_stream), "nms_mask")
        LAUNCHES += 1
        MASK_LAUNCHES += 1
    return alive


def nms_mask_plain(boxes: Tensor, scores: Tensor, iou_thresh: float,
                   score_thresh: float = 0.0) -> Tensor:
    """The kernel's function in plain torch, in the same division-free
    form and order of rounding; runs on any device."""
    _check(boxes, scores)
    n, k = scores.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    w = torch.clamp(torch.minimum(x2[:, :, None], x2[:, None, :])
                    - torch.maximum(x1[:, :, None], x1[:, None, :]), min=0.0)
    h = torch.clamp(torch.minimum(y2[:, :, None], y2[:, None, :])
                    - torch.maximum(y1[:, :, None], y1[:, None, :]), min=0.0)
    inter = w * h
    union = area[:, :, None] + area[:, None, :] - inter
    thresh = torch.tensor(iou_thresh, dtype=torch.float32,
                          device=boxes.device)
    idx = torch.arange(k, device=boxes.device)
    kill = (inter > thresh * union) & (union > 0.0) \
        & (idx[None, :] > idx[:, None])
    alive = scores > torch.tensor(score_thresh, dtype=torch.float32,
                                  device=scores.device)
    for i in range(k):
        alive = alive & ~(alive[:, i, None] & kill[:, i, :])
    return alive


def nms_mask(boxes: Tensor, scores: Tensor, iou_thresh: float,
             score_thresh: float = 0.0) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.

    Takes candidates already sorted by score ([N, K, 4], [N, K]), as the
    Pallas kernel does; :func:`odtpu_torch.ops.nms.nms_mask` is the
    counterpart of ``odtpu.ops.nms.nms_mask`` and sorts first."""
    if boxes.is_cuda:
        return nms_mask_cuda(boxes, scores, iou_thresh, score_thresh)
    if boxes.device.type != "cpu":
        raise ValueError("no NMS for tensors on {}".format(boxes.device))
    return nms_mask_plain(boxes, scores, iou_thresh, score_thresh)


def nms_rows_cuda(decoded: Tensor, order: Tensor, top_scores: Tensor,
                  cf: int, iou_thresh: float,
                  score_thresh: float = 0.0) -> Tensor:
    """The serving path's per-class NMS in one launch.

    decoded [B, P, 4] boxes, ``order`` and ``top_scores`` [B*cf, K] (the
    top-K candidates of each (image, class) set, score-sorted, int64
    indices into the image's P boxes) -> rows [B*cf, K, 5] =
    (score * alive, x1, y1, x2, y2) in candidate order. ``order`` and
    ``top_scores`` may be row slices of a wider array (last stride 1).
    An index outside [0, P) gives a NaN box and reads nothing (the plain
    twin raises).
    """
    global LAUNCHES, ROWS_LAUNCHES
    _check_rows(decoded, order, top_scores, cf)
    n, k = order.shape
    _check_cuda("nms_rows_cuda", k, decoded, order, top_scores)
    if decoded.dtype != torch.float32 or top_scores.dtype != torch.float32 \
            or order.dtype != torch.int64:
        raise TypeError("want float32 decoded and top_scores and int64 "
                        "order, got {}, {} and {}".format(
                            decoded.dtype, top_scores.dtype, order.dtype))
    if decoded.data_ptr() % 16:
        raise ValueError("decoded must start on a 16-byte boundary")
    rows = torch.empty((n, k, 5), dtype=torch.float32, device=decoded.device)
    if n and k:
        _launched(_kernel("odtpu_nms_rows")(
            decoded.data_ptr(), order.data_ptr(), top_scores.data_ptr(),
            rows.data_ptr(), n, k, cf, decoded.shape[1], order.stride(0),
            top_scores.stride(0), float(iou_thresh), float(score_thresh),
            torch.cuda.current_stream(decoded.device).cuda_stream),
            "nms_rows")
        LAUNCHES += 1
        ROWS_LAUNCHES += 1
    return rows


def _gather(decoded: Tensor, order: Tensor, cf: int) -> Tensor:
    """Set n's candidate boxes from image n // cf: [B*cf, K, 4]."""
    B, P, _ = decoded.shape
    image = torch.arange(B * cf, device=order.device) // cf
    return decoded.reshape(B * P, 4)[image[:, None] * P + order]


def nms_rows_plain(decoded: Tensor, order: Tensor, top_scores: Tensor,
                   cf: int, iou_thresh: float,
                   score_thresh: float = 0.0) -> Tensor:
    """:func:`nms_rows_cuda` in plain torch, same arguments and layout:
    the flat ``b * P + order`` gather, :func:`nms_mask_plain`, the rows."""
    _check_rows(decoded, order, top_scores, cf)
    boxes = _gather(decoded, order, cf)
    alive = nms_mask_plain(boxes, top_scores, iou_thresh, score_thresh)
    return torch.cat([(top_scores * alive)[..., None], boxes], dim=-1)


@torch.library.custom_op("odtpu::nms_rows", mutates_args=(),
                         device_types="cpu")
def _nms_rows_op(decoded: Tensor, order: Tensor, top_scores: Tensor,
                 cf: int, iou_thresh: float, score_thresh: float) -> Tensor:
    return nms_rows_plain(decoded, order, top_scores, cf, iou_thresh,
                          score_thresh)


_nms_rows_op.register_kernel("cuda")(nms_rows_cuda)


@_nms_rows_op.register_fake
def _(decoded, order, top_scores, cf, iou_thresh, score_thresh):
    return order.new_empty((*order.shape, 5), dtype=torch.float32)


def nms_rows(decoded: Tensor, order: Tensor, top_scores: Tensor, cf: int,
             iou_thresh: float, score_thresh: float = 0.0) -> Tensor:
    """The registered op ``odtpu::nms_rows``: :func:`nms_rows_cuda` for
    CUDA tensors, :func:`nms_rows_plain` for CPU tensors, and a
    ``[B*cf, K, 5]`` shape under ``torch.export``'s tracing, so that the
    live path and an exported program run the same op. Any other device
    raises."""
    return torch.ops.odtpu.nms_rows(decoded, order, top_scores, int(cf),
                                    float(iou_thresh), float(score_thresh))


def _top_order(conf_fg: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """conf_fg [B, P, C-1] -> each (image, class) set's k best scores and
    their indices, [B*(C-1), k], score-sorted (row slices, not copies)."""
    B, P, Cf = conf_fg.shape
    # contiguous: a sort keeps its input's strides, and at B = 1 a
    # reshape would be a transposed view. One copy at every B, and an
    # exported graph keeps it whatever B it was traced at
    scores = conf_fg.transpose(1, 2).contiguous().view(B * Cf, P)
    return top_k_exact(scores, k)


def top_candidates(decoded: Tensor, conf_fg: Tensor,
                   k: int) -> tuple[Tensor, Tensor]:
    """decoded [B, P, 4], conf_fg [B, P, C-1] -> the k best candidates of
    each (image, class) set: boxes [B*(C-1), k, 4] and scores
    [B*(C-1), k], score-sorted, contiguous: :func:`nms_mask`'s input."""
    top_scores, order = _top_order(conf_fg, k)
    return (_gather(decoded, order, conf_fg.shape[-1]),
            top_scores.contiguous())


def per_class_nms(decoded: Tensor, conf_fg: Tensor, conf_thresh: float,
                  nms_thresh: float, top_k: int,
                  compact_rows: bool = True) -> Tensor:
    """decoded [B, P, 4], conf_fg [B, P, C-1] -> [B, C-1, top_k, 5] rows
    (score, x1, y1, x2, y2).

    ``compact_rows=True`` (the dense contract, ``DetectOut``) runs the mask
    entry on the gathered candidates, as ``per_class_nms_pallas`` runs
    ``nms_mask_pallas``, and puts each set's survivors first.
    ``compact_rows=False`` (the serving path) is one :func:`nms_rows`
    launch: rows stay in candidate order, with dead rows' scores zeroed
    and their boxes left as they are. Only consumers that re-rank and
    mask by the score column (``detect._compact``) may take that.
    """
    B, P, _ = decoded.shape
    Cf = conf_fg.shape[-1]
    k = min(top_k, P)
    if compact_rows:
        top_boxes, top_scores = top_candidates(decoded, conf_fg, k)
        alive = nms_mask(top_boxes, top_scores, nms_thresh, conf_thresh)
        # candidates are score-sorted and scores are non-negative, so a
        # stable top-k over the alive-masked scores puts survivors first
        # in their order, then the zeroed rows
        masked = top_scores * alive
        rows = torch.cat([masked[..., None], top_boxes], dim=-1)
        row_scores, perm = top_k_exact(masked, k)
        rows = torch.gather(rows, 1, perm[..., None].expand(-1, -1, 5))
        rows = rows * (row_scores > 0.0)[..., None]  # zero dead rows' boxes
    else:
        top_scores, order = _top_order(conf_fg, k)
        rows = nms_rows(decoded, order, top_scores, Cf, nms_thresh,
                        conf_thresh)
    if k < top_k:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, top_k - k))
    return rows.reshape(B, Cf, top_k, 5)
