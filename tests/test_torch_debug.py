"""The debug entry, input-gradient saliency, the demos and the model-report
tools of the port against ``odtpu`` on the CPU, at small sizes.

- ``utils.visualize.viz_grads`` on SSD over VGG16-BN at 64x64 (the
  narrow steps' configuration of tests/test_torch_train_families.py, a
  batch-normed family, its norms' statistics drawn at random) against
  ``odtpu``'s gradients on the same weights and image: the raw input
  gradients of each source within 1e-9 relative L2 in float64 (``odtpu``
  with its float32 casts widened) and 1e-4 in float32 (``odtpu``'s
  ``viz_grads`` itself), the logged images within one level.
- ``train.backup_jobs`` names its directories as ``odtpu``'s does.
- ``train_debug.run`` on a seeded VOC tree at 64x64: one train step,
  the saliency images, one eval pass.
- ``tools.get_flops.conv_breakdown``'s rows equal root ``get_flops.py``'s
  for SSD300 (31.386288 G), RFBNet300 and SSD300 over DRN-D-22;
  ``tools.get_rf`` and ``tools.get_featuremap_size`` print what root
  ``get_rf.py`` and ``get_featuremap_size.py`` print for SSD300.
- The demos on the CPU: ``detect_img`` writes a PPM that differs from
  its input only in green; ``live --headless`` over a pattern of PPM
  frames gives frame 0 the rows ``detect_img`` gave the same image.
"""

import argparse
import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import get_featuremap_size as jget_featuremap_size
import get_flops as jget_flops
import get_rf as jget_rf
from odtpu.models import create_model as jcreate_model
from odtpu.utils import visualize as jvis
from odtpu.utils.config import default_cfg as jdefault_cfg
from odtpu.utils.logging import TBWriter as JTBWriter

from odtpu_torch import demo, train, train_debug
from odtpu_torch.data.image import imread, write_ppm
from odtpu_torch.demo import detect_img, live
from odtpu_torch.models import create_model, model_factory
from odtpu_torch.tools import get_featuremap_size, get_flops, get_rf
from odtpu_torch.utils.checkpoint import from_odtpu_params, load_strict
from odtpu_torch.utils.config import default_cfg, load_cfg
from odtpu_torch.utils.visualize import viz_grads

import torch_family_parity as fp
from synth import make_voc
from test_torch_train_families import tiny_cfg

torch.set_num_threads(2)

CASE = ("SSD", "vgg16", True)  # SSD over VGG16-BN


def _rel(got, want):
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / np.linalg.norm(want))


@pytest.fixture(scope="module")
def bn_pair():
    """The port's seeded SSD over VGG16-BN and ``odtpu``'s model of the
    same configuration, with the port's weights as ``odtpu``'s variables,
    their norms drawn at random (:func:`fp.random_norms`)."""
    cfg = tiny_cfg(default_cfg(), *CASE)
    model, _, _ = model_factory("eval", cfg, "cpu")
    jmodel, _ = jcreate_model(tiny_cfg(jdefault_cfg(), *CASE))
    variables = fp.random_norms(fp.odtpu_variables(model.state_dict()))
    load_strict(model, from_odtpu_params(fp.flat_variables(variables),
                                         model))
    return cfg, model.eval(), jmodel, variables


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9),
                                       ("float32", 1e-4)])
def test_viz_grads_matches_odtpu(bn_pair, dtype, tol, monkeypatch):
    """On a 32x32 image (the sources' sizes do not matter here, and the
    float64 convolutions are slow in XLA on the CPU). In float32 the
    gradients are ``odtpu``'s ``viz_grads``' own, taken as its
    ``jax.grad`` returns them; in float64 (``viz_grads`` casts its input
    to float32) ``jax.vjp`` of each source's sum, one compiled
    program. The variables are arguments of the compiled programs, not
    constants folded into them, which halves XLA's compile time."""
    cfg, model, jmodel, variables = bn_pair
    image = fp.images((32, 32), seed=1).astype(np.float32)
    image = np.ascontiguousarray((image - fp.MEANS)[..., ::-1])
    jtb = chip_smoke.recording_writer(JTBWriter)
    if dtype == "float64":
        # both models built to compute in float64, the same weights
        cfg = copy.deepcopy(cfg)
        cfg.TPU.COMPUTE_DTYPE = "float64"
        model, _ = create_model(cfg)
        load_strict(model, from_odtpu_params(fp.flat_variables(variables),
                                             model))
        model.eval().double()
        with fp.odtpu_float64():
            jcfg = tiny_cfg(jdefault_cfg(), *CASE)
            jcfg.TPU.COMPUTE_DTYPE = "float64"
            jmodel, _ = jcreate_model(jcfg)
            wide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                variables)
            jx = jnp.asarray(image, jnp.float64)

            def grad(v, x, i):
                out, vjp = jax.vjp(lambda xx: jmodel.apply(
                    v, xx, phase="eval", train=False,
                    return_sources=True)[-1], x)
                return vjp([jnp.full(o.shape, j == i, o.dtype)
                            for j, o in enumerate(out)])[0]

            grad = jax.jit(grad)
            want = [np.asarray(grad(wide, jx, i))[0] for i in range(4)]
    else:
        want = []
        real = jax.grad

        def grad(f):
            def run(*a):
                out = real(f)(*a)
                want.append(np.asarray(out)[0])
                return out
            return run

        monkeypatch.setattr(jax, "grad", grad)
        apply = jax.jit(lambda v, x: jmodel.apply(
            v, x, phase="eval", train=False, return_sources=True)[-1])
        jvis.viz_grads(functools.partial(apply, variables),
                       jnp.asarray(image), cfg.DATASET.PIXEL_MEANS, jtb)
    tb = chip_smoke.recording_writer()
    got = viz_grads(train_debug.source_fn(model), torch.from_numpy(image)
                    .to(getattr(torch, dtype)), cfg.DATASET.PIXEL_MEANS, tb)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.abs(w).max() > 0, i
        assert _rel(g, w) <= tol, (i, _rel(g, w))
    assert tb.writer.tags() == ["module_grads/source_{}".format(i)
                                for i in range(4)]
    if dtype == "float32":
        assert jtb.writer.tags() == tb.writer.tags()
        for (_, a, _), (_, b, _) in zip(tb.writer.images,
                                        jtb.writer.images):
            assert a.dtype == np.uint8 and a.shape == (32, 32, 3)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_backup_jobs_names_as_odtpu(tmp_path):
    cfg = default_cfg()
    cfg.GENERAL.HISTORY_ROOT = str(tmp_path / "history")
    args = argparse.Namespace(job_group="g", cfg_name="n")
    out, logs = tmp_path / "out", tmp_path / "logs"
    out.mkdir()
    logs.mkdir()
    (out / "config_used.json").write_text("{}")
    (logs / "events.0").write_text("e")
    dirs = [train.backup_jobs(cfg, str(out), str(logs), args)
            for _ in range(3)]
    base = str(tmp_path / "history" / "g" / "n")
    assert dirs == [base, base + "_1", base + "_2"]
    for d in dirs:
        assert sorted(os.listdir(d)) == ["events.0", "n.json"]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc") / "voc")
    make_voc(root, setname="trainval", n_images=4, seed=0, min_size=64,
             max_size=120)
    make_voc(root, setname="test", n_images=2, seed=1, start_id=4,
             min_size=64, max_size=120)
    return root


def test_train_debug_run_takes_a_step_saliency_and_an_eval(voc, tmp_path):
    cfg = tiny_cfg(default_cfg(), *CASE)
    cfg.DATASET.DATASET_DIR = voc
    cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
    cfg.DATASET.TRAIN_BATCH_SIZE = cfg.DATASET.EVAL_BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 1
    cfg.DATASET.DEVICE_PHOTOMETRIC = True  # a uint8 batch to convert
    cfg.LOG.SHOW_SALIENCY = True
    tb = chip_smoke.recording_writer()
    out = train_debug.run(cfg, "cpu", str(tmp_path / "dbg"), tb_writer=tb)
    m = out["metrics"]
    assert np.isfinite(m["loss"]) and m["num_pos"] > 0
    assert out["state"].step == 1 and out["state"].model.training
    # the saliency's parameters without requires_grad were put back
    assert all(p.requires_grad for p in out["state"].model.parameters())
    assert out["image"].shape == (1, 64, 64, 3)
    assert out["image"].dtype == np.float32
    assert len(out["grads"]) == 4
    assert tb.writer.tags() == ["module_grads/source_{}".format(i)
                                for i in range(4)]
    assert all(img.dtype == np.uint8 and img.std() > 0
               for _, img, _ in tb.writer.images)
    assert out["timing"]["images"] == 2 and 0.0 <= out["maps"][0] <= 1.0


@pytest.mark.parametrize("name", ["ssd_vgg16_voc", "rfbnet300_vgg16_voc",
                                  "ssd_drn22_voc"])
def test_conv_breakdown_equals_odtpu(name):
    rows, total = get_flops.conv_breakdown(load_cfg(name))
    jrows, jtotal = jget_flops.conv_breakdown(fp.jax_cfg(name))
    assert sorted(rows) == sorted(jrows)
    assert total == pytest.approx(jtotal, rel=1e-12)
    if name == "ssd_vgg16_voc":
        assert round(total, 6) == 31.386288


def test_rf_and_featuremap_reports_equal_odtpu(capsys, monkeypatch):
    assert get_rf.receptive_fields() == jget_rf.receptive_fields()
    get_rf.main()
    jget_rf.main()
    rf, jrf = capsys.readouterr().out.split("layer", 2)[1:]
    assert rf == jrf
    report = get_featuremap_size.main([])
    monkeypatch.setattr(sys, "argv", ["get_featuremap_size.py"])
    jget_featuremap_size.main()
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]
    assert report["total"] == 8732 and report["shapes"][0] == (38, 38, 512)


def test_demos_on_the_cpu(tmp_path, monkeypatch):
    """The two command lines share one seeded detector (built once by the
    first, as ``demo.detector`` builds it)."""
    built = []

    def detector(args):
        if not built:
            built.append(demo.detector(args))
        return built[0]

    monkeypatch.setattr(detect_img, "detector", detector)
    monkeypatch.setattr(live, "detector", detector)
    rng = np.random.RandomState(2)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        write_ppm(frames / "{:04d}.ppm".format(i + 1),
                  rng.randint(0, 256, (240, 320, 3)).astype(np.uint8))
    first = str(frames / "0001.ppm")
    out = str(tmp_path / "out.ppm")
    got = detect_img.main(["--image", first, "--out", out, "--device", "cpu",
                           "--conf", "0.05"])
    assert built[0].device.type == "cpu"
    assert got["kept"] == int((got["rows"][:, 0] >= 0.05).sum()) > 0
    drawn, src = imread(out), imread(first)
    changed = np.any(drawn != src, axis=-1)
    assert changed.any()
    assert (drawn[changed] == (0, 255, 0)).all()
    stream = live.main(["--source", str(frames / "%04d.ppm"), "--headless",
                        "--device", "cpu", "--max_frames", "2"])
    assert stream["frames"] == 2 and stream["fps"] > 0
    np.testing.assert_array_equal(stream["first_rows"], got["rows"])
