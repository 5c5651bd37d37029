"""One full-width train step of RefineDet320 in the port against
``odtpu``'s float32 step on the CPU, from the trained RefineDet320-ft
checkpoint (102 tensors), batch 2: the two-step loss with the trained
ARM's refined anchors and its negative-anchor filter, held as
tests/test_torch_train_rfbnet.py holds RFBNet300's (num_pos, the ODM's,
equal; losses within rtol 1e-4; the port's float64 updates within a
relative L2 error of 1e-3, its float32 ones within 1e-2; a gradient on
every parameter).
"""

import os.path as osp

import pytest

import torch_family_parity as fp
from test_torch_refinedet import REFINEDET_FT


def test_one_refinedet320_train_step_matches_odtpu():
    if not osp.isfile(REFINEDET_FT):
        pytest.skip("the RefineDet320-ft checkpoint is not in this checkout")
    loaded, (_, updates, stats, _), errors64, step = fp.full_width_step(
        "refinedet320_vgg16_voc", REFINEDET_FT)
    assert loaded == 102 and len(updates) == len(errors64) == 102
    assert not stats
    assert step.refinedet and step.odm_warm == 0
