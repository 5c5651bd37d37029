"""FPN-SSD: SSD with a top-down feature pyramid, and the bilinear upsample
the fusing families share.

Counterpart of ``odtpu/models/fpn.py``. SSD300's six sources (conv4_3
after L2Norm, conv7, four extras) each get a 1x1 lateral to 256
channels; the pyramid is built coarse to fine, and each level gets a
3x3/256 smoothing conv before the heads. The reference's quirk is kept:
each top-down step adds the *adjacent lateral*, upsampled, not the
accumulated pyramid (fpn_v2.py:86).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
from torch import Tensor, nn

from ..ops.detect import ssd_decode
from ..parallel import spatial
from .common import Conv, float32_or_wider
from .ssd import MultiBoxHead, build_trunk, outputs, run_trunk


def _align_corners_weights(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_out, n_in] matrix of a 1-D linear resize with
    align_corners=True: output i samples input coordinate
    i * (n_in - 1) / (n_out - 1); a side of 1 copies."""
    w = np.zeros((n_out, n_in), np.float32)
    if n_in == 1 or n_out == 1:
        w[:, 0] = 1.0
        return w
    coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(coords).astype(np.int64), 0, n_in - 2)
    frac = (coords - lo).astype(np.float32)
    w[np.arange(n_out), lo] = 1.0 - frac
    w[np.arange(n_out), lo + 1] += frac
    return w


@functools.lru_cache(maxsize=64)
def _weights(n_in: int, n_out: int, device: torch.device) -> Tensor:
    # read-only, and a normal tensor even when first asked for under
    # inference mode, so a train step's autograd may save it
    with torch.inference_mode(False):
        return torch.from_numpy(
            _align_corners_weights(n_in, n_out)).to(device)


def upsample_bilinear(x: Tensor, size) -> Tensor:
    """NCHW bilinear resize with torch's align_corners=True grid, the
    reference's ``F.upsample(mode='bilinear')`` under torch 0.3.1.

    As ``odtpu``'s: the interpolation matrices of the two sides applied
    as two products in float32 (or wider), cast back to ``x``'s dtype;
    the same size returns ``x``. Under a spatial plan the H matrix is
    over the map's global rows: this rank's output rows read the input
    rows they weigh, fetched (``parallel.spatial.resize_input``), and
    ``size``'s height, a slab's, is not read."""
    h, oh = spatial.heights(x, int(size[0]))
    w, ow = x.shape[3], int(size[1])
    if (oh, ow) == (h, w):
        return x
    xf = float32_or_wider(x)
    wh, xf = spatial.resize_input(xf, h, oh,
                                  _weights(h, oh, x.device).to(xf.dtype))
    ww = _weights(w, ow, x.device).to(xf.dtype)
    return torch.matmul(torch.matmul(wh, xf), ww.t()).to(x.dtype)


# the width of every lateral and pyramid level
FPN_DIM = 256


class FPN(nn.Module):
    """``forward(x, phase)`` -> (loc, conf), as :class:`SSD`."""

    decode = staticmethod(ssd_decode)

    def __init__(self, backbone: nn.Module, num_classes: int,
                 num_priors: Sequence[int], extras_spec: Sequence,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        channels = build_trunk(self, backbone, extras_spec, dtype)
        self.n_levels = n = len(channels)
        d = FPN_DIM
        for i, cin in enumerate(channels):
            self.add_module(f"transform_{i}", Conv(cin, d, 1, relu=False,
                                                   dtype=dtype))
        for idx in range(n):  # idx 0 is the coarsest level
            self.add_module(f"pyramid_{idx}", Conv(d, d, 3, padding=1,
                                                   relu=False, dtype=dtype))
        self.head = MultiBoxHead([d] * n, num_classes, num_priors, dtype)

    def forward(self, x: Tensor, phase: str = "train",
                return_sources: bool = False):
        sources = run_trunk(self, x)
        laterals = [getattr(self, f"transform_{i}")(s)
                    for i, s in enumerate(sources)]
        n = self.n_levels
        pyramids = []
        for idx in range(n):
            lat = laterals[n - 1 - idx]
            if idx:
                lat = lat + upsample_bilinear(laterals[n - idx],
                                              lat.shape[2:])
            pyramids.append(getattr(self, f"pyramid_{idx}")(lat))
        pyramids = pyramids[::-1]  # back to fine -> coarse
        return outputs(*self.head(pyramids), phase, pyramids,
                       return_sources)
