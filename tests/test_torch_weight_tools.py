"""The port's weight tools (``odtpu_torch/tools/``) against ``odtpu``'s on
the CPU.

- ``ckpt_to_npz``: a port checkpoint of a narrow batch-normed model (SSD
  over VGG16-BN at 64x64, its norms drawn at random, after one train
  step) becomes an npz that ``odtpu``'s ``load_variables_npz`` puts into
  ``odtpu``'s model; its forward in eval mode (loc and the raw logits)
  equals the port's within 1e-5 of each output's largest value in
  float32 (measured 2.8e-6: the two frameworks sum each conv in another
  order). With ``--dtype float16`` every array is the
  float16 rounding of the port's tensor, bit for bit, and the two
  packages' forwards on that npz agree within the same 1e-5.
- ``convert_torch_weights``: both modes write an npz key for key and bit
  for bit equal to ``tools/convert_torch_weights.py``'s, on a seeded
  state dict in the reference's key names and OIHW shapes that the test
  writes (no ``.pth`` is tracked): SSD (``base.N``, ``L2Norm``,
  ``extras.N``, ``loc.N``, ``conf.N``), FPN (``transforms.N``,
  ``pyramids.N``), a ``module.``-prefixed copy inside ``{'state_dict':
  ...}``, and a bare VGG16 ``Sequential``. The port's loaders then read
  every array back into its model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.models import model_factory as jmodel_factory
from odtpu.utils.checkpoint import load_variables_npz
from odtpu.utils.config import default_cfg as jdefault_cfg
from tools import convert_torch_weights as jconvert

from odtpu_torch.models import create_model, model_factory
from odtpu_torch.models.vgg import TORCH_INDEX_TO_NAME
from odtpu_torch.tools import ckpt_to_npz, convert_torch_weights
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils import config
from odtpu_torch.utils.checkpoint import (Checkpointer, from_odtpu_params,
                                          load_backbone_npz, load_basenet,
                                          load_model_npz, load_odtpu_npz,
                                          load_strict)
from odtpu_torch.utils.config import default_cfg

import torch_family_parity as fp
from test_torch_train_families import narrow_batch, tiny_cfg
from torch_tmp import drop_module_tmp  # noqa: F401

torch.set_num_threads(2)

CASE = ("SSD", "vgg16", True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint of the narrow VGG16-BN SSD after one train step from
    the port's seeded init, its norms drawn at random; ``jinit``, the
    same variables in ``odtpu``'s tree, is the template its npz loads
    into."""
    root = tmp_path_factory.mktemp("ckpt")
    jcfg = tiny_cfg(jdefault_cfg(), *CASE)
    cfg = tiny_cfg(default_cfg(), *CASE)
    jmodel, _, _ = jmodel_factory("eval", jcfg)
    state, priors = create_train_state(cfg, "cpu")
    variables = fp.random_norms(fp.odtpu_variables(state.model.state_dict()))
    load_strict(state.model, from_odtpu_params(fp.flat_variables(variables),
                                               state.model))
    images, boxes, labels = narrow_batch(cfg, [(8, 8), (4, 4), (2, 2),
                                               (1, 1)])
    make_train_step(priors, cfg)(state, torch.from_numpy(images),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(labels))
    Checkpointer(root / "ckpt").save(state.step, state)
    # odtpu's eval forward, compiled once for both dtypes' npz (their
    # variables load as float32 alike)
    japply = jax.jit(lambda v, x: jmodel.apply(v, x, phase="train",
                                               train=False))
    return {"root": root, "cfg": cfg, "japply": japply, "jinit": variables,
            "state": state}


def _forwards(trained, npz, image):
    """(port, odtpu) outputs of the model in ``npz`` in eval mode (the
    raw logits of phase "train", as tests/torch_family_parity.py holds
    forwards)."""
    with torch.device("meta"):  # no init: every tensor is loaded
        model, _ = create_model(trained["cfg"])
    model.to_empty(device="cpu")
    load_strict(model, load_odtpu_npz(npz, model))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(image), phase="train")
    variables, loaded, skipped = load_variables_npz(trained["jinit"], npz)
    assert not skipped and len(loaded) == len(np.load(npz).files)
    want = trained["japply"](variables, jnp.asarray(image))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_ckpt_to_npz_scores_in_odtpu_as_in_the_port(trained, dtype,
                                                    monkeypatch, capsys):
    out = str(trained["root"] / "model_{}.npz".format(dtype))
    # the command line, its config cut to the narrow net
    monkeypatch.setattr(config, "load_cfg", lambda name: trained["cfg"])
    ckpt_to_npz.main(["--cfg_name", "ssd_vgg16_voc", "--ckpt",
                      str(trained["root"] / "ckpt"), "--out", out,
                      "--dtype", dtype])
    assert "batch_stats arrays" in capsys.readouterr().out
    state = trained["state"]
    sd = state.model.state_dict()
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    assert {a.dtype for a in arrays.values()} == {np.dtype(dtype)}
    assert sum(k.startswith("__batch_stats__/") for k in arrays) == 2 * sum(
        k.endswith("running_var") for k in sd)
    for key, value in from_odtpu_params(arrays).items():
        np.testing.assert_array_equal(
            value.numpy(), sd[key].numpy().astype(dtype).astype(np.float32))

    image = (fp.images((64, 64), seed=6).astype(np.float32)
             - fp.MEANS)[..., ::-1].copy()
    got, want = _forwards(trained, out, image)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _reference_ssd_state_dict(model, seed=0):
    """The reference's key names and OIHW shapes for the port ``model``'s
    params (an SSD or FPN over VGG16), with seeded values; beside it the
    port key each reference key stands for."""
    index = {name: i for i, name in TORCH_INDEX_TO_NAME.items()}
    rng = np.random.RandomState(seed)
    ref, port = {}, {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        leaf = parts[-1]
        if parts[0] == "backbone":
            name = "base.{}.{}".format(index[parts[1]], leaf)
        elif parts[0] == "l2norm":
            name = "L2Norm.weight"
        elif parts[0] == "head":
            kind, i = parts[1].split("_")
            name = "{}.{}.{}".format(kind, i, leaf)
        else:  # extras_i, transform_i, pyramid_i
            kind, i = parts[0].split("_")
            kind = {"transform": "transforms", "pyramid": "pyramids"}.get(
                kind, kind)
            name = "{}.{}.{}".format(kind, i, leaf)
        ref[name] = torch.from_numpy(rng.normal(
            0, 0.1, value.shape).astype(np.float32))
        port[name] = key
    # a weightless layer's index and a key of nothing: both skipped
    ref["base.35.weight"] = torch.ones(3)
    ref["num_batches"] = torch.zeros(())
    return ref, port


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_same_npz(got, want):
    got, want = _npz(got), _npz(want)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("ssd_type", ["SSD", "FPN"])
def test_convert_ssd_equals_odtpu_tool_and_loads(tmp_path, ssd_type):
    cfg = tiny_cfg(default_cfg(), ssd_type)
    model, _, _ = model_factory("eval", cfg, "cpu")
    ref, port = _reference_ssd_state_dict(model)
    keys = len(model.state_dict())
    wrapped = {"iteration": 7, "step_index": 0,
               "state_dict": {"module." + k: v for k, v in ref.items()}}
    for name, sd in (("bare", ref), ("wrapped", wrapped)):
        src = tmp_path / "{}.pth".format(name)
        torch.save(sd, src)
        got, want = tmp_path / (name + "_port.npz"), tmp_path / (
            name + "_odtpu.npz")
        convert_torch_weights.main([str(src), str(got), "--mode", "ssd"])
        jconvert.convert_ssd(str(src), str(want))
        _assert_same_npz(got, want)
    # the seeded values differ from the model's init in every tensor
    loaded, skipped = load_model_npz(model, got)
    assert not skipped and len(loaded) == keys
    assert load_basenet(model, got)[0] == "full-path"
    after = model.state_dict()
    for name, key in port.items():
        np.testing.assert_array_equal(after[key].numpy(), ref[name].numpy())


def test_convert_vgg_equals_odtpu_tool_and_loads(tmp_path):
    cfg = tiny_cfg(default_cfg(), "SSD")
    model, _, _ = model_factory("eval", cfg, "cpu")
    rng = np.random.RandomState(1)
    ref = {}
    for i, name in sorted(TORCH_INDEX_TO_NAME.items()):
        conv = getattr(model.backbone, name).conv
        for leaf in ("weight", "bias"):
            ref["{}.{}".format(i, leaf)] = torch.from_numpy(rng.normal(
                0, 0.1, getattr(conv, leaf).shape).astype(np.float32))
    ref["35.weight"] = torch.ones(3)  # no conv at 35: skipped
    src = tmp_path / "vgg16_reducedfc.pth"
    torch.save(ref, src)
    got, want = tmp_path / "port.npz", tmp_path / "odtpu.npz"
    out = convert_torch_weights.convert(str(src), str(got))
    jconvert.convert_vgg(str(src), str(want))
    _assert_same_npz(got, want)
    assert len(out) == 30
    loaded, skipped = load_backbone_npz(model, got)
    assert len(loaded) == 30 and not skipped
    assert load_basenet(model, got)[0] == "backbone"
    for i, name in TORCH_INDEX_TO_NAME.items():
        conv = getattr(model.backbone, name).conv
        np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                      ref["{}.weight".format(i)].numpy())
