"""The port's model zoo against ``odtpu`` on the CPU: every named
configuration against its yml, every registry entry's feature-map dims
and priors, the align-corners upsample, and the full-width forward and
seeded init of FPN300, FSSD300, SSD300 over VGG16-BN and SSD512 (the
other families have files of their own). Tolerances are stated in
tests/torch_family_parity.py; the upsample is held at rtol/atol 1e-6
against ``odtpu``'s (the same matrices and products in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.models import model_factory as jmodel_factory
from odtpu.models.fpn import upsample_bilinear as jupsample
from odtpu.models.refinedet import refinedet320_cfg as jrefinedet320_cfg

from odtpu_torch.models import (BASE_REGISTRY, SSD_REGISTRY, SSD,
                                create_model, model_factory, register_base,
                                register_ssd)
from odtpu_torch.models.fpn import upsample_bilinear
from odtpu_torch.models.refinedet import refinedet320_cfg
from odtpu_torch.utils.checkpoint import from_odtpu_params, to_odtpu_params
from odtpu_torch.utils.config import CFGS, default_cfg, load_cfg

import torch_family_parity as fp


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + key + ".")
        else:
            yield prefix + key, value


@pytest.mark.parametrize("name", sorted(CFGS))
def test_config_matches_odtpu_yml(name):
    """Every key the port's config has equals ``odtpu.utils.config.
    load_cfg`` of the yml, after both fill their derived values."""
    want = fp.jax_cfg(name)
    got = load_cfg(name)
    n = 0
    for key, value in _leaves(got):
        node = want
        for part in key.split("."):
            node = node[part]
        if key == "MODEL.NUM_PRIOR":
            continue  # derived by the factory on both sides
        assert value == node, key
        n += 1
    assert n >= 40


def test_load_cfg_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown config"):
        load_cfg("ssd_vgg16_vox")
    assert load_cfg() == default_cfg()


def test_refinedet320_cfg_matches_odtpu():
    got = refinedet320_cfg(default_cfg())
    want = jrefinedet320_cfg(fp.jax_cfg("ssd_vgg16_voc"))
    for key in ("SSD_TYPE", "IMAGE_SIZE", "STEPS", "MIN_SIZES", "MAX_SIZES",
                "ASPECT_RATIOS"):
        assert got.MODEL[key] == want.MODEL[key], key
    assert got == load_cfg("refinedet320_vgg16_voc")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_factory_dims_and_priors_match_odtpu(name):
    _, jpriors, jdims = jmodel_factory("eval", fp.jax_cfg(name))
    _, priors, dims = model_factory("eval", load_cfg(name), device="cpu")
    assert dims == [tuple(d) for d in jdims]
    np.testing.assert_array_equal(priors.numpy(), np.asarray(jpriors))


def test_registries_cover_odtpu():
    from odtpu.models import BASE_REGISTRY as jbases, SSD_REGISTRY as jssds
    assert set(BASE_REGISTRY) == set(jbases)
    assert set(SSD_REGISTRY) == set(jssds)
    bases = {load_cfg(n).MODEL.BASE for n in CFGS}
    types = {load_cfg(n).MODEL.SSD_TYPE for n in CFGS}
    assert bases == set(BASE_REGISTRY)
    assert types | {"SSD_COCO"} == set(SSD_REGISTRY)


def test_register_base_and_ssd_reach_create_model():
    """A base and a detector added by the helpers, as ``odtpu``'s add
    them, are what ``create_model`` builds; both registries are put back
    after."""
    from odtpu import models as jmodels
    saved = [(r, dict(r)) for r in (BASE_REGISTRY, SSD_REGISTRY,
                                    jmodels.BASE_REGISTRY,
                                    jmodels.SSD_REGISTRY)]
    built = []

    def base(cfg, dtype, **kw):
        built.append(("base", kw))
        return BASE_REGISTRY["vgg16"](cfg, dtype, **kw)

    def detector(cfg, num_priors, dtype):
        built.append(("ssd", num_priors))
        return SSD_REGISTRY["SSD"](cfg, num_priors, dtype)

    try:
        register_base("vgg16_twin", base)
        register_ssd("SSD_twin", detector)
        jmodels.register_base("vgg16_twin", jmodels.BASE_REGISTRY["vgg16"])
        jmodels.register_ssd("SSD_twin", jmodels.SSD_REGISTRY["SSD"])
        assert set(BASE_REGISTRY) == set(jmodels.BASE_REGISTRY)
        assert set(SSD_REGISTRY) == set(jmodels.SSD_REGISTRY)
        cfg = default_cfg()
        cfg.MODEL.BASE, cfg.MODEL.SSD_TYPE = "vgg16_twin", "SSD_twin"
        with torch.device("meta"):
            model, prior = create_model(cfg)
        assert isinstance(model, SSD) and prior.num_priors == [
            4, 6, 6, 6, 4, 4]
        assert built == [("ssd", (4, 6, 6, 6, 4, 4)), ("base", {})]
    finally:
        for registry, entries in saved:
            registry.clear()
            registry.update(entries)
    assert "vgg16_twin" not in BASE_REGISTRY
    assert "SSD_twin" not in jmodels.SSD_REGISTRY


# tests/test_upsample.py's shapes, and one more in bfloat16
@pytest.mark.parametrize("hin,win,hout,wout,dtype", [
    (3, 3, 5, 5, "float32"), (5, 5, 10, 10, "float32"),
    (10, 10, 19, 19, "float32"), (19, 19, 38, 38, "float32"),
    (1, 1, 3, 3, "float32"), (4, 7, 9, 13, "float32"),
    (8, 8, 5, 5, "float32"), (19, 19, 38, 38, "bfloat16")])
def test_upsample_bilinear_matches_odtpu(hin, win, hout, wout, dtype):
    x = np.random.RandomState(hin * 100 + wout).randn(
        2, hin, win, 3).astype(np.float32)
    want = jupsample(jnp.asarray(x, dtype=dtype), (hout, wout))
    got = upsample_bilinear(
        torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2),
        (hout, wout))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want.astype(jnp.float32)), rtol=1e-6, atol=1e-6)


def test_upsample_bilinear_same_size_is_identity():
    x = torch.randn(1, 2, 5, 5)
    assert upsample_bilinear(x, (5, 5)) is x


# (configuration, MODEL.BATCH_NORM): VGG16-BN has no yml
FAMILIES = [("fpn_vgg16_voc", False), ("fssd_vgg16_voc", False),
            ("ssd_vgg16_voc", True), ("ssd_vgg16_voc_image512", False)]


@pytest.fixture(scope="module")
def pairs():
    return fp.Pairs()


@pytest.mark.parametrize("name,bn", FAMILIES)
def test_forward_matches_flax(pairs, name, bn):
    shapes = fp.check_forward(pairs(name, batch_norm=bn))
    assert shapes[1][-1] == 21


@pytest.mark.parametrize("name,bn", FAMILIES)
def test_init_follows_odtpu(pairs, name, bn):
    assert fp.check_init(pairs(name, batch_norm=bn)) >= 35


@pytest.mark.parametrize("name,bn", FAMILIES)
def test_bn_mapping_round_trips(pairs, name, bn):
    """odtpu's flat map -> the port's state dict -> back, unchanged: the
    batch norms' scale and statistics (``bn``, ``fusion_bn``) apart from
    the L2Norm scales."""
    pair = pairs(name, batch_norm=bn)
    flat = fp.flat_variables(pair["variables"])
    sd = from_odtpu_params(flat, pair["model"])
    back = to_odtpu_params(sd)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    has_bn = any(k.startswith("__batch_stats__/") for k in flat)
    assert has_bn == (name == "fssd_vgg16_voc" or bn)
    assert ("l2norm/scale" in flat) == (name != "fssd_vgg16_voc")
