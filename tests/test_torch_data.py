"""The port's data path against ``odtpu`` and OpenCV on the CPU: ``imread``,
the host sampler (built with g++ here) and its numpy twin, the colour
conversions and float resize, ``SSDAugmentation`` in its three modes,
the image cache and ``dataset_factory``.

Tolerances, and why:
- ``imread``, the sampler (both versions), every uint8 image, every box,
  label and Generator state: equal, bit for bit (the same integer
  arithmetic; the same draws in the same order);
- ``bgr_to_hsv``, ``hsv_to_bgr`` and ``resize_f32`` against cv2: 1e-3 on
  the 0-255 scale (H in degrees), inputs inside and outside [0, 255]
  (measured with OpenCV 5.0 on x86-64: 3.1e-5 for the conversions and
  1.2e-4 for the resize, cv2's SIMD sums rounding in another order);
- the float train images of ``SSDAugmentation`` and ``dataset_factory``:
  1e-2 on the 0-255 scale (measured: 2.3e-4).
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from odtpu.data import _native as jnative
from odtpu.data import dataset_factory as jdataset_factory
from odtpu.data.augment import SSDAugmentation as JSSDAugmentation
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch.data import augment, dataset_factory, image, native
from odtpu_torch.data.augment import SSDAugmentation
from odtpu_torch.data.cache import ImageCache, shared_cache
from odtpu_torch.data.voc import VOCDetection
from odtpu_torch.utils.config import default_cfg

from synth import make_voc

torch.set_num_threads(2)

COLOUR_TOL = 1e-3  # 0-255 scale
FLOAT_IMAGE_TOL = 1e-2  # 0-255 scale
# VOC's common sizes (h, w) and a few odd ones
SIZES = ((375, 500), (500, 375), (333, 500), (281, 500), (500, 332),
         (217, 301), (96, 480))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_voc(root, setname="trainval", n_images=8, seed=4, min_size=150,
             max_size=420)
    make_voc(root, setname="test", n_images=6, seed=5, start_id=8)
    return root


# --------------------------------------------------------------------------
# imread
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ppm_port", "ppm_cv2", "ppm_comments",
                                  "png", "jpg"])
def test_imread_matches_cv2(tmp_path, kind):
    img = np.random.RandomState(1).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    # the names lie about the format, as the seeded trees' .jpg PPMs do
    path = str(tmp_path / "x.jpg")
    if kind == "ppm_port":
        image.write_ppm(path, img)
    elif kind == "ppm_comments":
        with open(path, "wb") as f:
            f.write(b"P6 # made by hand\n53 # width\n37\n255\n"
                    + img[:, :, ::-1].tobytes())
    else:
        ext = {"ppm_cv2": ".ppm", "png": ".png", "jpg": ".jpg"}[kind]
        ok, buf = cv2.imencode(ext, img)
        assert ok
        with open(path, "wb") as f:
            f.write(buf.tobytes())
    got, want = image.imread(path), cv2.imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    if kind.startswith("ppm"):
        np.testing.assert_array_equal(got, img)


def test_imread_gives_none_where_cv2_does(tmp_path):
    assert image.imread(str(tmp_path / "missing.jpg")) is None
    short = str(tmp_path / "short.ppm")
    with open(short, "wb") as f:
        f.write(b"P6\n53 37\n255\n" + bytes(100))
    assert image.imread(short) is None and cv2.imread(short) is None


def test_imread_without_cv2_reads_ppm_and_names_other_formats(
        tmp_path, monkeypatch):
    img = np.random.RandomState(2).randint(0, 256, (9, 7, 3)).astype(
        np.uint8)
    ppm, jpg = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    image.write_ppm(ppm, img)
    cv2.imwrite(jpg, img)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    np.testing.assert_array_equal(image.imread(ppm), img)
    with pytest.raises(ImportError, match="JPEG"):
        image.imread(jpg)
    assert image.format_of(b"\x89PNG\r\n\x1a\n") == "PNG"


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

def _canvas_window(img, top, left, rect, flip, fill, out_hw):
    """cv2's route: the canvas materialized, the window cut (and flipped),
    cv2.resize."""
    x1, y1, x2, y2 = rect
    h, w, _ = img.shape
    ch, cw = max(y2, top + h), max(x2, left + w)
    canvas = np.empty((ch, cw, 3), np.uint8)
    canvas[:] = fill
    canvas[top:top + h, left:left + w] = img
    win = canvas[y1:y2, x1:x2]
    if flip:
        win = win[:, ::-1]
    return cv2.resize(np.ascontiguousarray(win), (out_hw[1], out_hw[0]),
                      interpolation=cv2.INTER_LINEAR)


def _sampler_cases(rng, n):
    for _ in range(n):
        h, w = rng.randint(1, 64), rng.randint(1, 64)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        fill = rng.randint(0, 256, 3).astype(np.uint8)
        ch, cw = rng.randint(h, 3 * h + 1), rng.randint(w, 3 * w + 1)
        top, left = rng.randint(0, ch - h + 1), rng.randint(0, cw - w + 1)
        x1 = rng.randint(0, cw)
        x2 = rng.randint(x1 + 1, cw + 1)
        y1 = rng.randint(0, ch)
        y2 = rng.randint(y1 + 1, ch + 1)
        yield (img, top, left, (x1, y1, x2, y2), bool(rng.randint(2)), fill,
               (rng.randint(1, 80), rng.randint(1, 80)))


def sampler_edge_cases():
    """(name, arguments): a 1-pixel window, a window wholly in the fill,
    a flip, and resizes by exactly 2x up and down."""
    img = np.random.RandomState(7).randint(0, 256, (40, 60, 3)).astype(
        np.uint8)
    fill = np.array([104, 117, 123], np.uint8)
    return (
        ("one_pixel_window", (img, 0, 0, (5, 7, 6, 8), False, fill,
                              (300, 300))),
        ("window_in_fill", (img, 50, 70, (0, 0, 40, 30), False, fill,
                            (300, 300))),
        ("flip", (img, 3, 4, (0, 0, 70, 50), True, fill, (300, 300))),
        ("exact_2x_up", (img, 0, 0, (0, 0, 60, 40), False, fill,
                         (80, 120))),
        ("exact_2x_down", (img, 0, 0, (0, 0, 60, 40), False, fill,
                           (20, 30))),
    )


def test_sampler_matches_odtpu_and_cv2():
    rng = np.random.RandomState(5)
    for args in _sampler_cases(rng, 150):
        got = native.fused_sample_u8(*args)
        np.testing.assert_array_equal(got, native.fused_sample_u8_plain(
            *args))
        np.testing.assert_array_equal(got, jnative.fused_sample_u8(*args))
        np.testing.assert_array_equal(got, _canvas_window(*args))


@pytest.mark.parametrize("name,args", sampler_edge_cases())
def test_sampler_edge_cases(name, args):
    got = native.fused_sample_u8(*args)
    np.testing.assert_array_equal(got, native.fused_sample_u8_plain(*args))
    np.testing.assert_array_equal(got, jnative.fused_sample_u8(*args))
    np.testing.assert_array_equal(got, _canvas_window(*args))
    if name == "window_in_fill":
        assert (got == args[5]).all()


def test_sampler_resize_matches_cv2():
    rng = np.random.RandomState(11)
    for _ in range(60):
        h, w = rng.randint(1, 90), rng.randint(1, 90)
        oh, ow = rng.randint(1, 120), rng.randint(1, 120)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            augment.resize_u8(img, (oh, ow)),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))


def test_sampler_refuses_bad_input_and_counts_calls():
    img = np.zeros((4, 4, 3), np.uint8)
    before = native.CALLS
    native.fused_sample_u8(img, 0, 0, (0, 0, 4, 4), False, (0, 0, 0),
                           (2, 2))
    assert native.CALLS == before + 1
    for bad in ((img, (0, 0, 0, 4), (2, 2)), (img, (0, 0, 4, 4), (0, 2)),
                (img.astype(np.float32), (0, 0, 4, 4), (2, 2))):
        with pytest.raises(ValueError):
            native.fused_sample_u8(bad[0], 0, 0, bad[1], False, (0, 0, 0),
                                   bad[2])
    assert native.CALLS == before + 1


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "sampler.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "out").iterdir())


# --------------------------------------------------------------------------
# colour conversions and the float resize
# --------------------------------------------------------------------------

def _colour_images():
    rng = np.random.RandomState(3)
    inside = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    # after brightness and contrast the distortion sees values off [0, 255]
    outside = rng.uniform(-90, 420, (48, 64, 3)).astype(np.float32)
    outside[:6, :6] = 77.0  # grey: S = 0
    outside[6:12, 6:12, 0] = outside[6:12, 6:12, 2]  # ties of the max
    return inside, outside


@pytest.mark.parametrize("which", [0, 1])
def test_hsv_conversions_match_cv2(which):
    img = _colour_images()[which]
    hsv = augment.bgr_to_hsv(img)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    err = np.abs(hsv - want).max()
    print("bgr_to_hsv max error", err)
    assert err <= COLOUR_TOL
    rng = np.random.RandomState(4)
    hsv = want.copy()
    hsv[..., 1] *= rng.uniform(0.5, 1.5)  # saturation past 1 too
    hsv[..., 0] = rng.uniform(0, 360, hsv.shape[:2])
    hsv[0, :4, 0] = (0.0, 360.0, 359.99997, 60.0)
    err = np.abs(augment.hsv_to_bgr(hsv)
                 - cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)).max()
    print("hsv_to_bgr max error", err)
    assert err <= COLOUR_TOL


@pytest.mark.parametrize("src,dst", [((375, 500), (300, 300)),
                                     ((1234, 877), (300, 300)),
                                     ((150, 150), (300, 300)),
                                     ((300, 300), (300, 300)),
                                     ((1, 500), (300, 300)),
                                     ((400, 2), (300, 300)),
                                     ((600, 600), (300, 300)),
                                     ((77, 1500), (512, 512))])
def test_resize_f32_matches_cv2(src, dst):
    img = np.random.RandomState(sum(src)).uniform(
        -300, 600, src + (3,)).astype(np.float32)
    got = augment.resize_f32(img, dst)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    err = np.abs(got - want).max()
    print("resize_f32", src, "->", dst, "max error", err)
    assert got.shape == want.shape and err <= COLOUR_TOL


# --------------------------------------------------------------------------
# SSDAugmentation
# --------------------------------------------------------------------------

MODES = {"eval_base": dict(use_base=True, device_normalize=True),
         "float_train": {},
         "uint8_device_photometric": dict(device_photometric=True)}


def _item(rng, shape):
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    n = rng.randint(1, 6)
    a, b = rng.rand(2, n, 2)
    boxes = np.concatenate([np.minimum(a, b), np.maximum(a, b)], 1)
    return img, boxes.astype(np.float32), rng.randint(0, 20, n)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ssd_augmentation_matches_odtpu(mode):
    ours, theirs = SSDAugmentation(**MODES[mode]), JSSDAugmentation(
        **MODES[mode])
    case = np.random.RandomState(3)
    worst = 0.0
    for seed in range(24):
        img, boxes, labels = _item(case, SIZES[seed % len(SIZES)])
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ours(img, boxes, labels, r1)
        want = theirs(img, boxes, labels, r2)
        assert got[0].dtype == want[0].dtype
        assert got[0].shape == want[0].shape == (300, 300, 3)
        if want[0].dtype == np.uint8:
            np.testing.assert_array_equal(got[0], want[0])
        else:
            worst = max(worst, float(np.abs(got[0] - want[0]).max()))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert r1.bit_generator.state == r2.bit_generator.state
    print(mode, "float image max error", worst)
    assert worst <= FLOAT_IMAGE_TOL


def test_item_without_ground_truth_takes_the_eval_resize():
    img = np.random.RandomState(0).randint(0, 256, (50, 70, 3)).astype(
        np.uint8)
    for kw in ({}, {"device_photometric": True}):
        got = SSDAugmentation(**kw)(img, np.zeros((0, 4), np.float32),
                                    np.zeros(0, np.int64))
        want = JSSDAugmentation(**kw)(img, np.zeros((0, 4), np.float32),
                                      np.zeros(0, np.int64))
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])


def test_geometry_draws_match_the_stepwise_ops():
    """The fused expand + crop gives the pixels of random_expand then
    random_sample_crop, with the same draws."""
    case = np.random.RandomState(8)
    mean = np.array([104, 117, 123], np.float32)
    for seed in range(12):
        img, boxes, labels = _item(case, (60, 80))
        img = img.astype(np.float32)
        boxes = boxes * np.array([80, 60, 80, 60], np.float32)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a = augment.random_expand_crop(img, boxes, labels, r1, mean)
        e_img, e_boxes = augment.random_expand(img, boxes, r2, mean)
        b = augment.random_sample_crop(e_img, e_boxes, labels, r2)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert r1.bit_generator.state == r2.bit_generator.state


# --------------------------------------------------------------------------
# the cache and dataset_factory
# --------------------------------------------------------------------------

def test_image_cache_copies_and_budget(voc):
    ds = VOCDetection(voc, (("2007", "test"),))
    paths = [ds.image_path(i) for i in range(len(ds))]
    cache = ImageCache(max_gb=1.0)
    first = cache.imread(paths[0])
    first[:] = 0  # the caller's copy: the cache keeps its own
    np.testing.assert_array_equal(cache.imread(paths[0]),
                                  cv2.imread(paths[0]))
    assert cache.stats()["images"] == 1
    tiny = ImageCache(max_gb=first.nbytes / (1 << 30) / 2)
    np.testing.assert_array_equal(tiny.imread(paths[0]),
                                  cv2.imread(paths[0]))
    assert tiny.stats() == {"images": 0, "bytes": 0, "refused": 1}
    assert shared_cache(voc) is shared_cache(voc + "/")
    cached = VOCDetection(voc, (("2007", "test"),),
                          image_cache=ImageCache())
    for i in range(len(ds)):
        for k in ("image", "boxes", "labels"):
            np.testing.assert_array_equal(cached[i][k], ds[i][k])


def _cfgs(voc, device_photometric):
    cfg, jcfg = default_cfg(), jdefault_cfg()
    for c in (cfg, jcfg):
        c.DATASET.DATASET_DIR = voc
        c.DATASET.TRAIN_SETS = (("2007", "trainval"),)
        c.DATASET.TRAIN_BATCH_SIZE = 4
        c.DATASET.EVAL_BATCH_SIZE = 4
        c.DATASET.NUM_WORKERS = 2
        c.DATASET.DEVICE_PHOTOMETRIC = device_photometric
    return cfg, jcfg


@pytest.mark.parametrize("phase,device_photometric", [
    ("train", False), ("train", True), ("eval", False)])
def test_dataset_factory_matches_odtpu(voc, phase, device_photometric):
    cfg, jcfg = _cfgs(voc, device_photometric)
    loader, jloader = dataset_factory(phase, cfg), jdataset_factory(
        phase, jcfg)
    assert len(loader) == len(jloader) == 2
    assert (loader.shuffle, loader.drop_last) == (phase == "train",) * 2
    n = 0
    for epoch in range(2 if phase == "train" else 1):
        for got, want in zip(loader, jloader):
            assert got["ids"] == want["ids"]
            for k in ("boxes", "labels", "extra", "indices"):
                np.testing.assert_array_equal(got[k], want[k])
            assert got["images"].dtype == want["images"].dtype
            if want["images"].dtype == np.uint8:
                np.testing.assert_array_equal(got["images"],
                                              want["images"])
            else:
                np.testing.assert_allclose(got["images"], want["images"],
                                           rtol=0, atol=FLOAT_IMAGE_TOL)
            n += 1
    assert n == (4 if phase == "train" else 2)


def test_dataset_factory_refuses_unknown_dataset(voc):
    cfg, _ = _cfgs(voc, False)
    cfg.DATASET.NAME = "KITTI"
    with pytest.raises(KeyError, match="KITTI"):
        dataset_factory("eval", cfg)


def test_sampler_library_goes_under_build():
    path = native.library_path()
    assert path.parent.name == "odtpu_torch"
    assert path.parent.parent.name == "build"
    assert os.path.basename(str(native.SOURCE)) == "sampler.cc"
