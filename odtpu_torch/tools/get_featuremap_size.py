"""The source feature maps of a configuration and their priors: ``python
-m odtpu_torch.tools.get_featuremap_size [--cfg_name NAME | --cfg YML]``.

Counterpart of root ``get_featuremap_size.py``: each source map's
height, width and channels from a forward on the ``meta`` device (shapes
only, as ``models.probe_layer_dims`` probes them), its anchors a cell and
its priors, and the total.
"""

from __future__ import annotations

import argparse

import torch

from ..models import create_model
from ..utils.config import resolve_cfg_args


def source_shapes(cfg) -> list[tuple[int, int, int]]:
    """(H, W, C) of each source map of one image."""
    h, w = cfg.MODEL.IMAGE_SIZE
    with torch.device("meta"):
        model, _ = create_model(cfg)
        model.eval()
        sources = model(torch.empty(1, h, w, 3), return_sources=True)[-1]
    return [(int(s.shape[2]), int(s.shape[3]), int(s.shape[1]))
            for s in sources]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="source feature-map shapes")
    p.add_argument("--cfg", default="")
    p.add_argument("--cfg_name", default="")
    p.add_argument("--job_group", default="")
    cfg = resolve_cfg_args(p.parse_args(argv))
    shapes = source_shapes(cfg)
    anchors = list(cfg.MODEL.NUM_PRIOR)  # create_model sets it
    h, w = cfg.MODEL.IMAGE_SIZE
    print("input: ({}, {}, 3)".format(h, w))
    for i, ((sh, sw, sc), a) in enumerate(zip(shapes, anchors)):
        print("source {}: {} x {} x {}ch  ({} anchors/cell -> {} priors)"
              .format(i, sh, sw, sc, a, a * sh * sw))
    total = sum(a * sh * sw for (sh, sw, _), a in zip(shapes, anchors))
    print("total priors:", total)
    return {"shapes": shapes, "anchors": anchors, "total": total}


if __name__ == "__main__":
    main()
