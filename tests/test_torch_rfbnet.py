"""RFBNet300 and RFBNet512 in the port against ``odtpu`` on the CPU:
the full-width forward and the seeded init (tolerances in
tests/torch_family_parity.py), and the eval step on the trained
RFBNet300-ft checkpoint, batch statistics included: the same classes and
``dropped`` as ``odtpu``'s ``make_eval_step``, rows within 1e-5, as the
flagship SSD300 test holds them.
"""

import os.path as osp

import numpy as np
import pytest

from odtpu.utils.checkpoint import load_variables_npz as jload_variables_npz

from odtpu_torch.utils.checkpoint import (load_odtpu_npz, load_strict,
                                          to_odtpu_params)

import torch_family_parity as fp
from torch_tmp import drop_module_tmp  # noqa: F401

# trained RFBNet300 (tests/synth.py images): 306 float16 tensors, 100 of
# them batch statistics
RFBNET_FT = osp.join(osp.dirname(__file__), "..", "history", "tests",
                     "rfbnet_ft_r5", "rfbnet_ft_r5_iter6000_f16.npz")


NAMES = ["rfbnet300_vgg16_voc", "rfbnet512_vgg16_voc"]


@pytest.fixture(scope="module")
def pairs():
    return fp.Pairs()


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_flax(pairs, name):
    fp.check_dims_and_priors(pairs(name))
    fp.check_forward(pairs(name))


@pytest.mark.parametrize("name", NAMES)
def test_init_follows_odtpu(pairs, name):
    assert fp.check_init(pairs(name)) >= 78


def test_eval_step_on_rfbnet_ft_weights_matches_odtpu(pairs, tmp_path):
    if not osp.isfile(RFBNET_FT):
        pytest.skip("the RFBNet300-ft checkpoint is not in this checkout")
    pair = pairs("rfbnet300_vgg16_voc")
    variables, loaded, skipped = jload_variables_npz(pair["variables"],
                                                     RFBNET_FT)
    assert len(loaded) == 306 and not skipped
    sd = load_odtpu_npz(RFBNET_FT, pair["model"])
    assert sum(k.endswith("running_var") for k in sd) == 50
    load_strict(pair["model"], sd)
    # the port's weights go back to odtpu whole: every tensor restored
    back = tmp_path / "back.npz"
    np.savez(back, **to_odtpu_params(pair["model"].state_dict()))
    _, loaded, skipped = jload_variables_npz(pair["variables"], back)
    assert len(loaded) == 306 and not skipped

    fp.check_eval_step(pair, variables)
