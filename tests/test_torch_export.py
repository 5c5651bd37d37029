"""The port's export entry point (``odtpu_torch/export.py``) against the
live port eval step and ``odtpu``'s ``tools/export_model.py`` on the CPU.

Tolerances, and why:
- the loaded artifact against the live ``EvalStep`` on the same batch:
  equal, float32 bit for bit, in float32 and in int8: the exported graph
  runs the same ops in the same order (the int8 weights quantized in the
  graph by the live path's own functions);
- against ``odtpu``'s own artifact on the same weights (carried by
  ``to_odtpu_params`` and given to both as an npz ``ckpt``):
  ``tests/test_export.py``'s rtol 1e-5 / atol 1e-6, the two frameworks
  summing each conv in another order;
- int8 against ``odtpu``'s int8 apply run eagerly (under ``jax.jit`` XLA
  turns ``s_x / 127`` into a product by 1/127 and whole layers'
  integers move, so its jitted export is not the reference), then its
  lax detect: the same rtol 1e-5 / atol 1e-6.
"""

import contextlib
import io
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odtpu.models
from odtpu.models import model_factory as jmodel_factory
from odtpu.models.common import quantized
from odtpu.ops.detect import detect_out_compact
from odtpu.utils.checkpoint import load_variables_npz, restore_eval_variables
from tools.export_model import export_artifact as jexport_artifact
from tools.export_model import load_artifact as jload_artifact

from odtpu_torch import export
from odtpu_torch.data.image import write_ppm
from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.infer import random_state_dict
from odtpu_torch.models import model_factory
from odtpu_torch.utils.checkpoint import load_strict, to_odtpu_params
from odtpu_torch.utils import config
from odtpu_torch.utils.config import default_cfg

from test_export import _tiny_cfg as jtiny_cfg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)


def tiny_cfg(base="vgg16"):
    """tests/test_export.py's 64x64 SSD on the port's config tree."""
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.BASE = base
    cfg.DATASET.IMAGE_SIZE = (64, 64)
    cfg.MODEL.IMAGE_SIZE = (64, 64)
    cfg.MODEL.STEPS = [8, 16, 32, 64]
    cfg.MODEL.MIN_SIZES = [12, 24, 40, 56]
    cfg.MODEL.MAX_SIZES = [24, 40, 56, 64]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2], [2], [2]]
    cfg.MODEL.EXTRAS = [64, "S", 128, 64, "S", 128]
    return cfg


@pytest.fixture(autouse=True, scope="module")
def odtpu_init_by_shapes():
    """``odtpu``'s ``init_model`` by shapes alone, as zeros: every test here
    loads all of ``odtpu``'s variables from an npz over that template
    (checked: as many loaded as there are variables, none skipped),
    while the eager init compiles each initializer op by op (~28 s for
    the drn_d_22 base)."""
    def init(model, cfg, rng=None, batch_size=1):
        h, w = cfg.MODEL.IMAGE_SIZE
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((batch_size, h, w, 3), jnp.float32), train=False))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(odtpu.models, "init_model", init)
        yield


def all_loaded(printed, num_weights):
    """``restore_eval_variables`` loaded every one of ``num_weights``
    variables from the npz, as it printed."""
    loaded = re.findall(r"model npz import: (\d+) loaded, (\d+) skipped",
                        printed)
    return loaded == [(str(num_weights), "0")]


def weights_npz(tmp_path, cfg, seed=0):
    """Seeded weights that decode finite boxes (``random_state_dict``;
    batch norm at its init, as tests/test_export.py's DRN case has it)
    as an ``odtpu`` npz (``to_odtpu_params``). Returns (path, state
    dict)."""
    sd = random_state_dict(cfg, seed=seed)
    path = tmp_path / "weights.npz"
    np.savez(path, **to_odtpu_params(sd))
    return str(path), sd


def live_step(cfg, sd, quant=""):
    cfg.TPU.QUANT = quant
    model, priors, _ = model_factory("eval", cfg, "cpu")
    load_strict(model, sd)
    return make_eval_step(model, priors, cfg)


def batch_of(b, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, 64, 64, 3),
                                               dtype=np.uint8)


# a fresh interpreter that loads an artifact with load_artifact, serves
# one batch and lists the modules it imported
LOADER = """
import sys
import numpy as np
import torch
from odtpu_torch.export import load_artifact
call, meta = load_artifact({art!r}, "cpu")
torch.save(call(np.load({x!r})), {out!r})
print(" ".join(sorted(sys.modules)))
"""


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    """A fixed-batch (2) artifact of the tiny SSD over VGG16 on seeded
    weights, written by the command line: ``--cfg`` names SSD300's yml,
    and the tree it loads is cut to the tiny net. The artifact's loader
    subprocess (:data:`LOADER`) starts here and runs beside the tests
    before the one that reads it."""
    root = tmp_path_factory.mktemp("vgg")
    npz, sd = weights_npz(root, tiny_cfg())
    art = str(root / "vgg.zip")
    asked, out = [], io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(config, "load_cfg",
                   lambda name: asked.append(name) or tiny_cfg())
        export.main(["export", "--out", art, "--cfg",
                     "cfgs/base/ssd_vgg16_voc.yml", "--ckpt", npz,
                     "--batch", "2", "--device", "cpu"])
    assert asked == ["ssd_vgg16_voc"]
    x = batch_of(2, seed=7)
    np.save(root / "x.npy", x)
    loader = subprocess.Popen(
        [sys.executable, "-c", LOADER.format(
            art=art, x=str(root / "x.npy"), out=str(root / "rows.pt"))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield {"root": root, "art": art, "npz": npz, "sd": sd, "x": x,
           "loader": loader, "printed": json.loads(out.getvalue())}
    loader.kill()
    loader.communicate()


def test_command_line_exports_and_runs(vgg, capsys):
    printed = vgg["printed"]
    assert printed["out"] == vgg["art"] and printed["size_mb"] > 0
    assert printed["image_size"] == [64, 64] and printed["batch"] == 2
    img = np.random.RandomState(3).randint(0, 256, (75, 100, 3),
                                           dtype=np.uint8)
    write_ppm(vgg["root"] / "img.ppm", img)
    export.main(["run", "--artifact", vgg["art"], "--image",
                 str(vgg["root"] / "img.ppm"), "--conf", "0.0", "--device",
                 "cpu"])
    dets = json.loads(capsys.readouterr().out)["detections"]
    call, meta = export.load_artifact(vgg["art"], "cpu")
    assert dets == export.run_image(call, meta, img, 0.0)
    assert 0 < len(dets) <= 200
    for det in dets:
        assert det["class"] in meta["class_names"] and det["score"] > 0


def test_artifact_equals_live_step(vgg):
    call, meta = export.load_artifact(vgg["art"], "cpu")
    assert meta == {k: v for k, v in vgg["printed"].items()
                    if k not in ("out", "size_mb")}
    assert meta["model"] == "SSD-vgg16" and meta["quant"] == ""
    assert meta["platforms"] == ["cpu", "cuda"] and meta["dtype"] == "float32"
    assert len(meta["class_names"]) == 20 and meta["num_weights"] > 0
    x = batch_of(2)
    got = call(x)
    assert got.shape == (2, 200, 6)
    assert torch.isfinite(got).all() and (got[..., 0] > 0).any()
    assert torch.equal(got, live_step(tiny_cfg(), vgg["sd"])(x)["rows"])


def test_polymorphic_batchnorm_artifact_equals_live_and_odtpu(tmp_path,
                                                             capsys):
    """A drn_d_22 base (batch norm) exported for any batch, at B=1 and
    B=3, against the live step and ``odtpu``'s polymorphic artifact on
    the same npz. (With every norm's statistics drawn at random one box
    edge of 1,200 values lay 7.2e-6 from ``odtpu``'s, 2.2e-5 relative:
    the 8 residual blocks grow the two frameworks' rounding.)"""
    cfg = tiny_cfg("drn_d_22")
    npz, sd = weights_npz(tmp_path, cfg, seed=1)
    art = str(tmp_path / "poly.zip")
    meta = export.export_artifact(art, cfg, ckpt=npz, batch=0, device="cpu")
    assert meta["batch"] == 0 and meta["model"] == "SSD-drn_d_22"
    call, _ = export.load_artifact(art, "cpu")
    step = live_step(tiny_cfg("drn_d_22"), sd)
    jcfg = jtiny_cfg()
    jcfg.MODEL.BASE = "drn_d_22"
    jart = str(tmp_path / "poly.odtpux")
    jmeta = jexport_artifact(jart, ckpt=npz, batch=0, cfg=jcfg)
    assert all_loaded(capsys.readouterr().out, jmeta["num_weights"])
    jcall, _ = jload_artifact(jart)
    for b in (1, 3):
        x = batch_of(b, seed=b)
        got = call(x)
        assert got.shape == (b, cfg.EVAL.TOP_K, 6)
        assert torch.isfinite(got).all() and (got[..., 0] > 0).any()
        assert torch.equal(got, step(x)["rows"])
        np.testing.assert_allclose(got.numpy(), jcall(x), **TOL)


def test_int8_artifact_equals_live_int8_and_odtpu_eager(tmp_path, vgg):
    cfg = tiny_cfg()
    npz, sd = vgg["npz"], vgg["sd"]
    art = str(tmp_path / "int8.zip")
    meta = export.export_artifact(art, cfg, ckpt=npz, batch=1,
                                  quant="int8", device="cpu")
    assert meta["quant"] == "int8" and cfg.TPU.QUANT == ""
    call, _ = export.load_artifact(art, "cpu")
    x = batch_of(1, seed=5)
    got = call(x)
    assert torch.equal(got, live_step(tiny_cfg(), sd, "int8")(x)["rows"])

    jcfg = jtiny_cfg()
    jmodel, priors, _ = jmodel_factory("eval", jcfg)
    variables, loaded, skipped = load_variables_npz(
        restore_eval_variables(jmodel, jcfg), npz)
    assert len(loaded) == len(jax.tree.leaves(variables)) and not skipped
    xf = (x.astype(np.float32)
          - np.float32(jcfg.DATASET.PIXEL_MEANS))[..., ::-1]
    with quantized("int8"):  # eager: see the module docstring
        loc, conf = jmodel.apply(variables, jnp.asarray(xf.copy()),
                                 phase="eval", train=False)
    want = detect_out_compact(loc, conf, jnp.asarray(priors),
                              tuple(jcfg.MODEL.VARIANCE),
                              conf_thresh=jcfg.EVAL.CONF_THRESH,
                              nms_thresh=jcfg.EVAL.NMS_THRESH,
                              top_k=jcfg.EVAL.TOP_K, impl="lax")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_artifact_loads_without_models_and_refuses_wrong_input(vgg):
    art, root, x = vgg["art"], vgg["root"], vgg["x"]
    stdout, stderr = vgg["loader"].communicate(timeout=240)
    assert vgg["loader"].returncode == 0, stderr
    loaded = stdout.split()
    assert "odtpu_torch.ops.cuda.nms_kernel" in loaded
    assert not [m for m in loaded if m.startswith(
        ("odtpu_torch.models", "odtpu_torch.utils", "odtpu_torch.data",
         "jax", "odtpu."))], loaded
    call, meta = export.load_artifact(art, "cpu")
    assert torch.equal(torch.load(root / "rows.pt"), call(x))

    with zipfile.ZipFile(art) as z:
        assert set(z.namelist()) == {"meta.json", export.PROGRAM}
        assert json.loads(z.read("meta.json")) == meta
    for bad in (batch_of(1), x[:, :32], x.astype(np.float32), x[0]):
        with pytest.raises(ValueError, match="exported"):
            call(bad)
