"""One full-width train step of RFBNet300 in the port against
``odtpu``'s float32 step on the CPU, from the trained RFBNet300-ft
checkpoint (306 tensors, 100 of them batch statistics), batch 2: num_pos
equal, the losses within rtol 1e-4, the port's float64 update of every
tensor within a relative L2 error of 1e-3 and its float32 one within
1e-2, every running statistic after the step within 1e-5, and a gradient
on every parameter (tests/torch_family_parity.py ``full_width_step`` and
``check_train_step`` say why). Its own file, so that the tier-1 run's
workers take it beside the other full-width steps.
"""

import os.path as osp

import pytest

import torch_family_parity as fp
from test_torch_rfbnet import RFBNET_FT


def test_one_rfbnet300_train_step_matches_odtpu():
    if not osp.isfile(RFBNET_FT):
        pytest.skip("the RFBNet300-ft checkpoint is not in this checkout")
    loaded, (_, updates, stats, _), errors64, _ = fp.full_width_step(
        "rfbnet300_vgg16_voc", RFBNET_FT)
    assert loaded == 306
    assert len(updates) == len(errors64) == 206 and len(stats) == 100
