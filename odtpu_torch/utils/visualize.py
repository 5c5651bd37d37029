"""Images for TensorBoard: boxes, anchors, feature maps, saliency.

Counterpart of ``odtpu/utils/visualize.py`` (the reference's
lib/utils/visualize_utils.py: draw_bbox:16, vis_img_box:42,
viz_archor_strategy:238, viz_feature_maps:135, viz_grads:152, and
prior_box.py:55-90's anchor renderings), without OpenCV, which the
card's machine lacks. What ``odtpu`` asks of cv2 is drawn here in numpy,
pixel for pixel as cv2 draws it (uint8 BGR, clipped at the image's
edges):

- :func:`rectangle`: ``cv2.rectangle`` at thickness 1 (the one-pixel
  outline) and 2 (a band from p - 1 to p + 1 about each edge, its four
  outer corner pixels left out);
- ``cv2.circle`` of radius 1, filled, is the 5-pixel plus
  (:func:`viz_prior_anchors` draws every cell's at once);
- :func:`put_text`: labels in a 3x5 bitmap font of this module's own
  (cv2's Hershey glyphs are cv2's data), at cv2's anchor, the text's
  baseline-left corner, in the same colour; it stays inside the band
  that cv2's ``FONT_HERSHEY_SIMPLEX`` at 0.45 would cover.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.boxes import jaccard, point_form
from ..ops.matching import match

# 3x5 glyphs, rows top to bottom, 3 bits a row (left bit first); letters
# are drawn as capitals, anything else as "?"
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", "a": "010101111101101", "b": "110101110101110",
    "c": "011100100100011", "d": "110101101101110", "e": "111100110100111",
    "f": "111100110100100", "g": "011100101101011", "h": "101101111101101",
    "i": "111010010010111", "j": "001001001101010", "k": "101101110101101",
    "l": "100100100100111", "m": "101111111101101", "n": "110101101101101",
    "o": "010101101101010", "p": "110101110100100", "q": "010101101110011",
    "r": "110101110101101", "s": "011100010001110", "t": "111010010010010",
    "u": "101101101101111", "v": "101101101101010", "w": "101101111111101",
    "x": "101101010101101", "y": "101101010010010", "z": "111001010100111",
    ".": "000000000000010", "-": "000000111000000", "_": "000000000000111",
    " ": "000000000000000", "?": "111001010000010",
}
_GLYPH_MASKS = {k: np.asarray([int(b) for b in v], bool).reshape(5, 3)
                for k, v in _GLYPHS.items()}
GLYPH_ADVANCE = 4  # 3 columns and a gap


def _fill(img, r0, r1, c0, c1, color):
    """Rows r0..r1 and columns c0..c1 (inclusive), clipped to ``img``."""
    h, w = img.shape[:2]
    r0, c0 = max(r0, 0), max(c0, 0)
    r1, c1 = min(r1, h - 1), min(c1, w - 1)
    if r0 <= r1 and c0 <= c1:
        img[r0:r1 + 1, c0:c1 + 1] = color


def rectangle(img, p1, p2, color, thickness=1):
    """``cv2.rectangle(img, p1, p2, color, thickness)`` in place, for
    thickness 1 or 2 and integer corners anywhere (drawing stops at the
    image's edges)."""
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    if thickness == 1:
        for r in (ya, yb):
            _fill(img, r, r, xa, xb, color)
        for c in (xa, xb):
            _fill(img, ya, yb, c, c, color)
        return img
    if thickness != 2:
        raise ValueError("thickness 1 or 2, got {}".format(thickness))
    h, w = img.shape[:2]
    corners = [(r, c) for r in (ya - 1, yb + 1) for c in (xa - 1, xb + 1)
               if 0 <= r < h and 0 <= c < w]
    # the corner pixels outside every band keep what they had
    kept = [img[r, c].copy() for r, c in corners]
    for r in (ya, yb):
        _fill(img, r - 1, r + 1, xa - 1, xb + 1, color)
    for c in (xa, xb):
        _fill(img, ya - 1, yb + 1, c - 1, c + 1, color)
    for (r, c), v in zip(corners, kept):
        img[r, c] = v
    return img


# the 5-pixel plus of a filled circle of radius 1, as (dy, dx)
_PLUS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def put_text(img, text, org, color):
    """``text`` in place with its baseline-left corner at ``org`` (x, y):
    5 rows above and on the baseline, 4 columns a character."""
    h, w = img.shape[:2]
    x0, y0 = int(org[0]), int(org[1]) - 4
    for i, ch in enumerate(str(text).lower()):
        mask = _GLYPH_MASKS.get(ch, _GLYPH_MASKS["?"])
        for r, c in zip(*np.nonzero(mask)):
            y, x = y0 + r, x0 + i * GLYPH_ADVANCE + c
            if 0 <= y < h and 0 <= x < w:
                img[y, x] = color
    return img


def draw_boxes(image, boxes, labels=None, scores=None, color=(0, 255, 0),
               class_names=None):
    """Draw point-form pixel boxes on a uint8 BGR image copy."""
    img = np.ascontiguousarray(image).astype(np.uint8).copy()
    h, w = img.shape[:2]
    boxes = np.asarray(boxes).reshape(-1, 4)
    for i, b in enumerate(boxes):
        p1 = (int(np.clip(b[0], 0, w - 1)), int(np.clip(b[1], 0, h - 1)))
        p2 = (int(np.clip(b[2], 0, w - 1)), int(np.clip(b[3], 0, h - 1)))
        rectangle(img, p1, p2, color, 2)
        text = ""
        if labels is not None:
            li = int(np.asarray(labels).reshape(-1)[i])
            text = class_names[li] if class_names else str(li)
        if scores is not None:
            text += " {:.2f}".format(float(np.asarray(scores).reshape(-1)[i]))
        if text:
            put_text(img, text, (p1[0], max(p1[1] - 3, 10)), color)
    return img


def vis_img_box(image, boxes_dict, tb_writer, tag="detect", step=0,
                class_names=None):
    """Log an image with 'gt' (red) and/or 'pred' (green) boxes.

    boxes_dict: {'gt': [N,5] (box+label), 'pred': [M,6] (score,box,cls)}.
    """
    img = np.ascontiguousarray(image).astype(np.uint8)
    if "gt" in boxes_dict and len(boxes_dict["gt"]):
        gt = np.asarray(boxes_dict["gt"])
        img = draw_boxes(img, gt[:, :4], gt[:, 4].astype(int),
                         color=(0, 0, 255), class_names=class_names)
    if "pred" in boxes_dict and len(boxes_dict["pred"]):
        pr = np.asarray(boxes_dict["pred"])
        img = draw_boxes(img, pr[:, 1:5], pr[:, 5].astype(int), pr[:, 0],
                         color=(0, 255, 0), class_names=class_names)
    tb_writer.add_image(tag, img[:, :, ::-1], step)  # BGR -> RGB for TB


def anchor_match_stats(priors, gt_boxes, gt_labels, variances=(0.1, 0.2),
                       threshold=0.5):
    """Anchor-coverage statistics over a set of padded GT batches.

    Returns dict of numpy arrays: matched counts per GT, per-anchor best
    IoU, matched anchor w/h/ar — the data behind the reference's
    viz_archor_strategy histograms (visualize_utils.py:238-345).
    """
    priors_np = np.asarray(priors, np.float32)
    priors = torch.from_numpy(priors_np)
    stats = {"gt_w": [], "gt_h": [], "matched_per_gt": [],
             "best_iou_per_gt": [], "anchor_w": [], "anchor_h": []}
    for boxes, labels in zip(gt_boxes, gt_labels):
        valid = np.asarray(labels) >= 0
        if not np.any(valid):
            continue
        b = torch.as_tensor(np.asarray(boxes, np.float32))
        lab = torch.as_tensor(np.asarray(labels))
        overlaps = jaccard(b, point_form(priors)).numpy()
        _, conf_t, best_idx = match(b, lab, priors, variances, threshold)
        conf_t, best_idx = conf_t.numpy(), best_idx.numpy()
        for gi in np.nonzero(valid)[0]:
            sel = (best_idx == gi) & (conf_t > 0)
            stats["matched_per_gt"].append(int(sel.sum()))
            stats["best_iou_per_gt"].append(float(overlaps[gi].max()))
            stats["gt_w"].append(float(boxes[gi, 2] - boxes[gi, 0]))
            stats["gt_h"].append(float(boxes[gi, 3] - boxes[gi, 1]))
            pw = priors_np[sel]
            stats["anchor_w"].extend(pw[:, 2].tolist())
            stats["anchor_h"].extend(pw[:, 3].tolist())
    return {k: np.asarray(v) for k, v in stats.items()}


def viz_anchor_strategy(stats, tb_writer, step=0):
    """Log anchor-coverage histograms to TB."""
    if tb_writer.writer is None:
        return
    for key, arr in stats.items():
        if len(arr):
            tb_writer.add_histogram("anchors/" + key, arr, step)


def viz_feature_maps(sources, tb_writer, tag="features", step=0):
    """Log per-source mean-activation heatmaps (visualize_utils.py:135) of
    the model's NCHW ``sources``, first image."""
    for i, s in enumerate(sources):
        fm = torch.as_tensor(s)[0].detach().permute(1, 2, 0).cpu().numpy()
        heat = np.ascontiguousarray(fm).mean(-1)
        rng = heat.max() - heat.min()
        heat = (heat - heat.min()) / (rng + 1e-9)
        img = (np.stack([heat] * 3, -1) * 255).astype(np.uint8)
        tb_writer.add_image("{}/source_{}".format(tag, i), img, step)


def viz_grads(source_fn, image, pixel_means, tb_writer, tag="module_grads",
              step=0):
    """Input-gradient saliency per source feature map.

    For each source i, the gradient of ``sum(source_i)`` (in float32, or
    wider) with respect to the network input, clipped at 0, the pixel
    mean added back, clipped to 0-255, logged as a uint8 RGB image
    (reference visualize_utils.py viz_grads:152 / viz_module_grads:189).
    One forward, its graph kept until the last source's backward; on a
    card each eval-mode batch norm's backward runs its kernel's dx entry,
    which takes the norm's parameters without ``requires_grad``
    (``train_debug.input_gradient_mode``).

    Args:
        source_fn: NHWC image [1,H,W,3] (RGB, mean-subtracted) -> list of
            source feature maps (e.g. the model with
            ``return_sources=True``).
        image: [H,W,3] or [1,H,W,3] network-input image, numpy or a
            tensor (on the device the model runs on).
        pixel_means: BGR means (cfg.DATASET.PIXEL_MEANS) added back for
            visibility, channel-flipped to the RGB input order.
    Returns the raw gradients, [H,W,3] float64 numpy arrays a source.
    """
    x = torch.as_tensor(image)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if x.dim() == 3:
        x = x[None]
    x = x.detach().requires_grad_()
    sources = source_fn(x)
    mean_rgb = np.asarray(pixel_means, np.float32)[::-1]
    grads = []
    for i, s in enumerate(sources):
        score = s.to(torch.promote_types(s.dtype, torch.float32)).sum()
        g, = torch.autograd.grad(score, x,
                                 retain_graph=i < len(sources) - 1)
        g = g[0].detach().cpu().numpy()
        grads.append(g.astype(np.float64))
        sal = np.clip(np.clip(g, 0, None) + mean_rgb, 0, 255)
        tb_writer.add_image("{}/source_{}".format(tag, i),
                            sal.astype(np.uint8), step)
    return grads


def viz_prior_anchors(prior_box, layer_dims, tb_writer, image=None, step=2,
                      tag="base/feature_map"):
    """Per-feature-map anchor renderings.

    Parity: the reference's lib/layers/functions/prior_box.py:55-90
    (_prior_vis under the @vis decorator): for every feature map k and
    every anchor slot a, draw each cell's center as a red dot and, on
    the diagonal cells only, the anchor rectangle in green; one TB image
    per (map, slot) tagged base/feature_map_{k}_{a}. The cells are drawn
    in ``odtpu``'s order (row by row, each cell's dot before its
    rectangle), all at once: a pixel takes the colour of the last mark
    that covers it.

    Args:
        prior_box: a PriorBoxSSD (uses image_size/steps/_cell_priors).
        layer_dims: [(H_k, W_k), ...] measured feature-map dims.
        image: optional uint8 BGR background (resized to the network's
            input by the host resize); blank white otherwise.
    """
    from ..data.augment import resize_u8

    img_h, img_w = prior_box.image_size
    if image is None:
        base = np.full((img_h, img_w, 3), 255, np.uint8)
    else:
        base = resize_u8(np.ascontiguousarray(image, np.uint8),
                         (img_h, img_w))
    for k, (fh, fw) in enumerate(layer_dims):
        steps_x = img_w / prior_box.steps[k]
        steps_y = img_h / prior_box.steps[k]
        cx = (np.arange(fw) + 0.5) / steps_x
        cy = (np.arange(fh) + 0.5) / steps_y
        px = (cx * img_w).astype(np.int64)  # int(): toward zero, >= 0
        py = (cy * img_h).astype(np.int64)
        # the draw order of each cell's dot (its row-major index)
        dot_at = np.full((img_h, img_w), -1, np.int64)
        order = np.arange(fh * fw).reshape(fh, fw)
        for dy, dx in _PLUS:
            yy, xx = np.meshgrid(py + dy, px + dx, indexing="ij")
            ok = (yy >= 0) & (yy < img_h) & (xx >= 0) & (xx < img_w)
            np.maximum.at(dot_at, (yy[ok], xx[ok]), order[ok])
        for a in range(prior_box.num_priors[k]):
            # each diagonal cell's rectangle, drawn just after its dot
            rect_at = np.full((img_h, img_w), -1, np.int64)
            for d in range(min(fh, fw)):
                c = prior_box._cell_priors(cx[d], cy[d], k)[a]
                p1 = (int((c[0] - c[2] / 2) * img_w),
                      int((c[1] - c[3] / 2) * img_h))
                p2 = (int((c[0] + c[2] / 2) * img_w),
                      int((c[1] + c[3] / 2) * img_h))
                mark = np.zeros((img_h, img_w), bool)
                rectangle(mark, p1, p2, True, 1)
                rect_at[mark] = order[d, d]
            im = base.copy()
            im[dot_at >= 0] = (0, 0, 255)
            im[(rect_at >= 0) & (rect_at >= dot_at)] = (0, 255, 0)
            tb_writer.add_image("{}_{}_{}".format(tag, k, a),
                                im[:, :, ::-1], step)
