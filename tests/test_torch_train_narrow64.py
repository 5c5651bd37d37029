"""The narrow train steps of tests/test_torch_train_families.py (FPN,
FSSD, SSD-DRN22, DRN_SSD, VGG16-BN SSD at 64x64, batch 2, batch norms
drawn at random) taken in float64 on both sides: ``odtpu``'s step under
``jax.enable_x64`` with its float32 casts widened
(tests/torch_family_parity.py ``odtpu_float64``), the port's model in
``double()``, from the same float32 values. Held by ``check_train_step``:
num_pos equal, the losses within rtol 1e-4, every update within a relative L2 error of 1e-3, the running
statistics within 1e-5, a gradient on every parameter that feeds the
loss. In float64 no ReLU sign flips under rounding, so what the float32
steps cannot show at 1e-3 (a missing weight decay on a norm's scale, a
biased variance taken for the unbiased one) shows here. Its own file, so
that the tier-1 run's workers take it beside the float32 steps.
"""

import numpy as np
import pytest

import torch_family_parity as fp
from test_torch_train_families import (NARROW, _pair_states, narrow_batch,
                                       unused_params)


@pytest.mark.parametrize("case", NARROW,
                         ids=["fpn", "fssd", "ssd_drn22", "drnssd",
                              "ssd_vgg16_bn"])
def test_narrow_float64_train_step_matches_odtpu(case, monkeypatch):
    with fp.odtpu_float64():
        jstate, jstep, state, step, cfg, dims = _pair_states(
            case, monkeypatch, "float64")
        images, boxes, labels = narrow_batch(cfg, dims)
        _, updates, stats, _ = fp.check_train_step(
            jstate, jstep, state, step, images.astype(np.float64), boxes,
            labels, unused=unused_params(case, state.model))
    assert bool(stats) == (case != ("FPN", "vgg16", False))
    # the reading PERF.md quotes (pytest -s)
    print("{}: largest float64 update error {:.3g}".format(
        case, max(updates.values())))
