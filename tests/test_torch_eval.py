"""The port's VOC data, loader, mAP, evaluator, checkpoints and train loop
against the JAX package on the CPU.

The VOC trees come from ``tests/synth.py`` ``make_voc`` (seeded images
with class-coloured boxes, the data the flagship checkpoint was trained
on). Tolerances, and why:
- annotations, loader batches, AP and mAP from the same detections:
  equal (abs 1e-9 for the mAP; the same float64 numpy arithmetic);
- ``EvalVOC.validate`` with the flagship weights: mAP within 1e-4 (the
  forward sums in another order in the two frameworks, so a score can
  move in its last digits and two near-equal detections swap ranks);
- the resumed train loop against the unbroken one: bit-equal;
- the dense contract (``EVAL.COMPACT = False``) of the narrow SSD of
  tests/test_torch_train_families.py against ``odtpu``'s
  ``make_eval_step(compact=False)``: rtol 1e-4, atol 1e-5 (the rows of
  ``odtpu``'s own mesh tests); its one ``nms_rows`` route against the
  mask route of the dense contract: equal; VOC and COCO scores through
  the evaluators: equal to the compact path's where it drops nothing.
"""

import os.path as osp
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.data import VOCDetection as JVOCDetection
from odtpu.data import dataset_factory
from odtpu.data import pad_batch_to as jpad_batch_to
from odtpu.data.voc import parse_voc_xml as jparse_voc_xml
from odtpu.eval import evaluator as jevaluator
from odtpu.eval import voc_eval as jvoc_eval
from odtpu.models import init_model, model_factory as jmodel_factory
from odtpu.parallel import make_eval_step as jmake_eval_step
from odtpu.utils.checkpoint import load_model_npz as jload_model_npz
from odtpu.utils.config import default_cfg as jdefault_cfg

from odtpu_torch.data import dataset_factory as tdataset_factory
from odtpu_torch.data.loader import DetLoader, NetworkInput, pad_batch_to
from odtpu_torch.data.voc import VOCDetection, parse_voc_xml
from odtpu_torch.eval import voc_eval
from odtpu_torch.eval.evaluator import EvalVOC, eval_solver_factory
from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.models import model_factory
from odtpu_torch.ops.detect import detect_decoded
from odtpu_torch.train import fit
from odtpu_torch.train_step import create_train_state
from odtpu_torch.utils import checkpoint
from odtpu_torch.utils.config import default_cfg, load_cfg

import chip_smoke
import torch_family_parity as fp
from synth import make_coco, make_voc
from test_torch_model import FLAGSHIP
from test_torch_train_families import _jax_model, tiny_cfg
from torch_tmp import drop_module_tmp  # noqa: F401

# the tier-1 run puts 6 pytest workers on the CPU's cores: more torch
# threads per worker only contend with the others (and with JAX)
torch.set_num_threads(2)

TEST_SETS = (("2007", "test"),)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_voc(root, n_images=6, seed=3)
    return root


@pytest.fixture(scope="module")
def voc2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc2"))
    make_voc(root, n_images=2, seed=5)
    return root


def _detections(rng, dataset, n_classes=21):
    """Seeded detections near the GT boxes (and some far off), as the
    evaluator's results[cls][img] = [N, 5] (x1, y1, x2, y2, score)."""
    results = [[np.zeros((0, 5), np.float32) for _ in range(len(dataset))]
               for _ in range(n_classes)]
    for i in range(len(dataset)):
        boxes, labels, _ = jparse_voc_xml(dataset.anno_path(i),
                                          norm_box=False)
        for box, label in zip(boxes, labels):
            for cls in (label + 1, rng.randint(1, n_classes)):
                n = rng.randint(1, 4)
                jitter = rng.uniform(-15, 15, (n, 4))
                score = rng.uniform(0.01, 1.0, (n, 1))
                det = np.concatenate([box + jitter, score], 1)
                results[cls][i] = np.concatenate(
                    [results[cls][i], det]).astype(np.float32)
    return results


def test_voc_annotations_and_loader_match_odtpu(voc):
    jds = JVOCDetection(voc, TEST_SETS)
    ds = VOCDetection(voc, TEST_SETS, reader=cv2.imread)
    assert ds.ids == jds.ids and len(ds) == 6
    for i in range(len(ds)):
        for a, b in zip(parse_voc_xml(ds.anno_path(i), keep_difficult=True),
                        jparse_voc_xml(jds.anno_path(i), keep_difficult=True)):
            np.testing.assert_array_equal(a, b)
        got, want = ds[i], jds[i]
        for k in ("image", "boxes", "labels", "extra"):
            np.testing.assert_array_equal(got[k], want[k])
    # with no reader the dataset decodes through image.imread (the tree's
    # JPEGs through cv2 here)
    default = VOCDetection(voc, TEST_SETS)
    for i in range(len(ds)):
        np.testing.assert_array_equal(default[i]["image"], jds[i]["image"])

    jcfg = jdefault_cfg()
    jcfg.DATASET.DATASET_DIR = voc
    jcfg.DATASET.TEST_SETS = TEST_SETS
    jcfg.DATASET.EVAL_BATCH_SIZE = 4
    jloader = dataset_factory("eval", jcfg)
    loader = DetLoader(ds, jloader.transform, batch_size=4, num_workers=2)
    assert len(loader) == len(jloader) == 2
    for got, want in zip(loader, jloader):
        assert got["ids"] == want["ids"]
        for k in ("images", "boxes", "labels", "extra", "indices"):
            np.testing.assert_array_equal(got[k], want[k])
        padded, valid = pad_batch_to(got, 4)
        jpadded, jvalid = jpad_batch_to(want, 4)
        assert valid == jvalid
        for k in ("images", "boxes", "labels"):
            np.testing.assert_array_equal(padded[k], jpadded[k])
    # the pass-through transform refuses what it cannot resize
    with pytest.raises(ValueError, match="cannot resize"):
        NetworkInput((300, 300))(ds[0]["image"], None, None)


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_and_map_match_odtpu(voc, tmp_path, use_07):
    rng = np.random.RandomState(4)
    jds = JVOCDetection(voc, TEST_SETS)
    ds = VOCDetection(voc, TEST_SETS, reader=cv2.imread)
    results = _detections(rng, jds)
    rec = np.sort(rng.uniform(0, 1, 30))
    prec = rng.uniform(0, 1, 30)
    assert voc_eval.voc_ap(rec, prec, use_07) == jvoc_eval.voc_ap(
        rec, prec, use_07)
    gt = {i: {"bbox": [[10, 10, 50, 60], [30, 30, 90, 80]],
              "difficult": [0, 1]} for i in range(3)}
    dets = [(i % 3, float(s), 12.0 + i, 11.0, 52.0, 58.0)
            for i, s in enumerate(rng.uniform(0, 1, 7))]
    for a, b in zip(voc_eval.eval_class(dets, gt, 0.5, use_07),
                    jvoc_eval.eval_class(dets, gt, 0.5, use_07)):
        np.testing.assert_array_equal(a, b)
    got_res, got = voc_eval.evaluate_detections(
        results, ds, str(tmp_path / "port"), use_07_metric=use_07)
    want_res, want = jvoc_eval.evaluate_detections(
        results, jds, str(tmp_path / "odtpu"), use_07_metric=use_07)
    assert 0.05 < want < 1.0
    assert abs(got - want) <= 1e-9
    assert [r[1] for r in got_res] == [r[1] for r in want_res]
    for name in ("det_test_dog.txt", "annots.pkl"):
        assert osp.isfile(tmp_path / "port" / name)
    with open(tmp_path / "port" / "det_test_dog.txt") as f, \
            open(tmp_path / "odtpu" / "det_test_dog.txt") as g:
        assert f.read() == g.read()


def test_eval_voc_validate_with_flagship_weights_matches_odtpu(voc,
                                                               tmp_path):
    if not osp.isfile(FLAGSHIP):
        pytest.skip("the flagship checkpoint is not in this checkout")
    jcfg, cfg = jdefault_cfg(), default_cfg()
    for c in (jcfg, cfg):
        c.TPU.COMPUTE_DTYPE = "float32"
        c.DATASET.TEST_SETS = TEST_SETS
    jcfg.DATASET.DATASET_DIR = voc
    jcfg.DATASET.EVAL_BATCH_SIZE = 4
    jloader = dataset_factory("eval", jcfg)
    jmodel, jpriors, _ = jmodel_factory("eval", jcfg)
    params, loaded, _ = jload_model_npz(init_model(jmodel, jcfg)["params"],
                                        FLAGSHIP)
    assert len(loaded) == 71
    jsolver = jevaluator.EvalVOC(jloader, jcfg, str(tmp_path / "odtpu"))
    jstep = jmake_eval_step(jmodel, jpriors, jcfg)
    # the step op by op (its raw_step), which skips a whole-graph compile
    _, jmaps = jsolver.validate(
        lambda p, b, x: jstep.raw_step(p, b, jstep.priors, jnp.asarray(x)),
        params, {})

    model, priors, _ = model_factory("eval", cfg, "cpu")
    model.load_state_dict(checkpoint.load_odtpu_npz(FLAGSHIP, model))
    loader = DetLoader(VOCDetection(voc, TEST_SETS, reader=cv2.imread),
                       jloader.transform, batch_size=4, num_workers=2)
    solver = EvalVOC(loader, cfg, str(tmp_path / "port"))
    _, maps = solver.validate(make_eval_step(model.eval(), priors, cfg))
    assert jmaps[0] > 0.3
    assert abs(maps[0] - jmaps[0]) <= 1e-4
    assert solver.last_timing["images"] == 6
    assert solver.last_timing["dropped_dets"] == \
        jsolver.last_timing["dropped_dets"]


def test_checkpointer_and_partial_npz_loads(tmp_path):
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    state, _ = create_train_state(cfg, "cpu")
    ck = checkpoint.Checkpointer(tmp_path / "ckpt", max_to_keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(state)
    for s in (1, 2, 3):
        state.step = s
        assert ck.save(s, state)
    assert not ck.save(3, state)  # kept unless forced
    assert ck.save(3, state, force=True)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    state.step = 0
    assert ck.restore(state, step=2).step == 2

    model = state.model
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 3, 64).astype(np.float32)  # HWIO
    np.savez(tmp_path / "backbone.npz", **{
        "conv1_1/kernel": w, "conv1_1/bias": np.ones(64, np.float32),
        "conv9_9/kernel": w})
    scheme, loaded, skipped = checkpoint.load_basenet(
        model, tmp_path / "backbone.npz")
    assert scheme == "backbone" and skipped == ["conv9_9/kernel"]
    assert sorted(loaded) == ["conv1_1/bias", "conv1_1/kernel"]
    np.testing.assert_array_equal(
        model.backbone.conv1_1.conv.weight.detach().numpy(),
        w.transpose(3, 2, 0, 1))
    assert torch.equal(model.backbone.conv1_2.conv.weight,
                       sd["backbone.conv1_2.conv.weight"])
    np.savez(tmp_path / "full.npz", **{
        "l2norm/scale": np.full(512, 7, np.float32),
        "head/loc_0/conv/kernel": np.zeros((3, 3, 5, 5), np.float32),
        "backbone/conv1_1/conv/bias": np.zeros(64, np.float32),
        "__batch_stats__/x/mean": np.zeros(3, np.float32)})
    scheme, loaded, skipped = checkpoint.load_basenet(
        model, tmp_path / "full.npz")
    assert scheme == "full-path"
    assert sorted(loaded) == ["backbone/conv1_1/conv/bias", "l2norm/scale"]
    assert skipped == ["head/loc_0/conv/kernel"]
    assert float(model.l2norm.scale.detach()[0]) == 7.0
    np.savez(tmp_path / "other.npz", **{"fpn/lat_0/conv/kernel": w})
    with pytest.raises(ValueError, match="matched no parameters"):
        checkpoint.load_basenet(model, tmp_path / "other.npz")


def _fit_cfg(max_iter):
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    cfg.DATASET.TEST_SETS = TEST_SETS
    cfg.TRAIN.OPTIMIZER.LR = 1e-5  # bench.py's; 1e-3 diverges from init
    cfg.TRAIN.MAX_ITER = max_iter
    cfg.TRAIN.SAVE_ITER = 2
    cfg.TRAIN.EVAL_ITER = 3
    cfg.TRAIN.LOG_LOSS_ITER = 1
    return cfg


def _fit_loaders(voc, cfg, out):
    """The tree's two images at 300x300, as one unshuffled batch of 2 (so
    every step trains on the same batch) and as the test set."""
    images = {}

    def reader(path):
        if path not in images:
            img = cv2.imread(path)
            images[path] = cv2.resize(img, (300, 300))
        return images[path]

    train = DetLoader(VOCDetection(voc, TEST_SETS, reader=reader),
                      NetworkInput((300, 300)), batch_size=2,
                      drop_last=True, num_workers=1)
    test = DetLoader(VOCDetection(voc, TEST_SETS, reader=reader),
                     NetworkInput((300, 300)), batch_size=2, num_workers=1)
    return train, EvalVOC(test, cfg, str(out / "eval"))


def test_fit_saves_validates_and_resumes_bit_equal(voc2, tmp_path):
    """3 steps at B=2 with a save every 2 and a validation at 3; then a
    run that auto-resumes from the step-2 checkpoint and ends where the
    unbroken run ended, bit for bit (model, momentum, step)."""
    cfg = _fit_cfg(3)
    train, solver = _fit_loaders(voc2, cfg, tmp_path / "a")
    a = fit(cfg, train, solver, tmp_path / "a", device="cpu")
    assert a["step"] == 3 and a["ckpt_steps"] == [2, 3]
    assert sorted(p.name for p in (tmp_path / "a" / "ckpt").iterdir()) \
        == ["2.pt", "3.pt"]
    assert [e["step"] for e in a["evals"]] == [3]
    assert 0.0 <= a["evals"][0]["mAP"] <= 1.0
    assert [m["step"] for m in a["losses"]] == [1, 2]
    assert all(np.isfinite(m["loss"]) and m["num_pos"] > 0
               for m in a["losses"])
    saved = torch.load(tmp_path / "a" / "ckpt" / "2.pt", weights_only=True)
    assert saved["step"] == 2 and len(saved["model"]) == 71

    (tmp_path / "b" / "ckpt").mkdir(parents=True)
    (tmp_path / "b" / "ckpt" / "2.pt").write_bytes(
        (tmp_path / "a" / "ckpt" / "2.pt").read_bytes())
    train, solver = _fit_loaders(voc2, cfg, tmp_path / "b")
    b = fit(cfg, train, solver, tmp_path / "b", device="cpu",
            auto_resume=True)
    assert b["step"] == 3 and b["evals"][0]["mAP"] == a["evals"][0]["mAP"]
    sa, sb = a["state"], b["state"]
    assert sb.step == sa.step == 3
    for (ka, va), (kb, vb) in zip(sa.model.state_dict().items(),
                                  sb.model.state_dict().items()):
        assert ka == kb and torch.isfinite(va).all(), ka
        assert torch.equal(va, vb), ka
    ma = sa.optimizer.state_dict()["state"]
    mb = sb.optimizer.state_dict()["state"]
    assert ma.keys() == mb.keys() and all(
        torch.equal(ma[i]["momentum_buffer"], mb[i]["momentum_buffer"])
        for i in ma)


# --- the dense contract, EVAL.COMPACT = False ---

def _narrow_ssd(cfg):
    """The narrow SSD of ``cfg`` on the CPU in eval mode, its seeded
    weights with the first conv divided by 64 (the raw pixels' scale
    taken out, as ``infer.random_state_dict`` does, so that the boxes
    decode finite), and its priors."""
    model, priors, _ = model_factory("eval", tiny_cfg(cfg, "SSD"), "cpu")
    with torch.no_grad():
        model.backbone.conv1_1.conv.weight /= 64
    return model.eval(), priors


def test_dense_eval_step_meets_odtpu():
    """The rows at rtol 1e-4 and atol 1e-5, where a row off must have
    swapped places with one of a score within 1e-5 of its own
    (``chip_smoke.rows_apart``): the random weights' scores lie close
    together (~1/21), and a last-bit difference of float32 scores
    between the two frameworks orders two of them otherwise."""
    cfg = default_cfg()
    cfg.EVAL.COMPACT = False
    model, priors = _narrow_ssd(cfg)
    images = np.random.RandomState(3).randint(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    step = make_eval_step(model, priors, cfg)
    dense = step(images)
    assert dense.shape == (2, 21, 200, 5)
    # one nms_rows launch a batch on a card: its rows, survivors first,
    # are the mask route's of the dense contract
    decoded = step.decode(*step.forward(torch.from_numpy(images)))
    assert torch.equal(dense, detect_decoded(
        *decoded, step.conf_thresh, step.nms_thresh, step.top_k,
        row_compact=True))
    jmodel, jpriors = _jax_model(tiny_cfg(jdefault_cfg(), "SSD"))
    jstep = jmake_eval_step(jmodel, jpriors, tiny_cfg(jdefault_cfg(), "SSD"),
                            compact=False)
    want = torch.from_numpy(np.array(jstep.raw_step(
        fp.odtpu_variables(model.state_dict())["params"], {}, jstep.priors,
        jnp.asarray(images))))
    assert (want[..., 0] > 0).sum() > 100
    sets = (-1, dense.shape[2], 5)
    off = chip_smoke.rows_apart(dense.reshape(sets), want.reshape(sets))
    assert len(off) <= 16 and all(o[-1] for o in off), off


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_coco(root, n_images=4, seed=9)
    return root


def _planted(step, dataset, batch):
    """``step`` whose decoded boxes and scores carry each image's ground
    truth at its first priors (score 0.9 for its class, 0 for the
    others), beside the narrow model's own low-scoring detections: the
    detect path and the evaluators then score above 0."""
    truth = [dataset[i] for i in range(len(dataset))]
    decode, calls = step.decode, [0]

    def planted(*outputs):
        boxes, conf = (t.clone() for t in decode(*outputs))
        for k in range(boxes.shape[0]):
            i = calls[0] * batch + k
            if i < len(truth):
                labels = torch.from_numpy(truth[i]["labels"]).long()
                n = len(labels)
                boxes[k, :n] = torch.from_numpy(truth[i]["boxes"])
                conf[k, :n] = 0.0
                conf[k, torch.arange(n), labels + 1] = 0.9
        calls[0] += 1
        return boxes, conf

    step.decode = planted
    return step


@pytest.mark.parametrize("data", ["voc", "coco"])
def test_dense_contract_scores_as_the_compact_rows(request, data, tmp_path):
    """The narrow SSD, with the ground truth planted among its
    detections, over the tree's test set through ``EvalVOC`` or
    ``EvalCOCO``: the dense contract scores what the compact rows score
    when their cap (``EVAL.COMPACT_ROWS`` = C * TOP_K) drops nothing."""
    cfg = load_cfg("ssd_vgg16_" + data)
    if data == "coco":  # the tree's 5 categories
        cfg.DATASET.NUM_CLASSES, cfg.MODEL.NUM_CLASSES = 5, 6
    model, priors = _narrow_ssd(cfg)
    cfg.DATASET.DATASET_DIR = request.getfixturevalue(data)
    cfg.DATASET.TEST_SETS = (("2014", "val"),) if data == "coco" \
        else TEST_SETS
    cfg.DATASET.EVAL_BATCH_SIZE = 4
    cfg.DATASET.NUM_WORKERS = 1
    cfg.DATASET.NUM_EVAL_PICS = 0
    cfg.EVAL.TOP_K = 20
    cfg.EVAL.COMPACT_ROWS = cfg.MODEL.NUM_CLASSES * cfg.EVAL.TOP_K
    loader = tdataset_factory("eval", cfg)
    scored = {}
    for compact in (True, False):
        solver = eval_solver_factory(loader, cfg, str(tmp_path / str(
            compact)))
        step = _planted(make_eval_step(model, priors, cfg, compact),
                        loader.dataset, 4)
        _, maps = solver.validate(step)
        scored[compact] = maps, solver.last_timing
    assert scored[True][1]["dropped_dets"] == 0
    assert scored[False][1]["dropped_dets"] == 0
    assert scored[False][1]["images"] == scored[True][1]["images"] > 0
    assert min(scored[True][0]) > 0.1
    assert scored[False][0] == scored[True][0]


# --- odtpu's pycocotools path, under a stand-in pycocotools ---

def _stand_in_pycocotools(calls):
    """Modules ``pycocotools``, ``.coco`` and ``.cocoeval`` whose
    ``COCO`` and ``COCOeval`` record how they are called and give a
    seeded precision array [T, R, K, A, M] with -1 where a category has
    no ground truth."""
    import types

    class COCO:
        def __init__(self, anno_file):
            calls.append(("COCO", anno_file))

        def loadRes(self, rows):
            calls.append(("loadRes", rows.dtype.name, rows.tolist()))
            return "pred"

    class COCOeval:
        def __init__(self, gt, pred, kind):
            calls.append(("COCOeval", kind, pred))
            self.params = types.SimpleNamespace(imgIds=None)

        def evaluate(self):
            calls.append(("imgIds", self.params.imgIds))

        def accumulate(self):
            p = np.random.RandomState(5).rand(10, 101, 3, 4, 3)
            p[:, :, 1] = -1.0
            p[0, :50, 2] = -1.0
            self.eval = {"precision": p}

        def summarize(self):
            calls.append(("summarize",))

    pkg = types.ModuleType("pycocotools")
    coco = types.ModuleType("pycocotools.coco")
    cocoeval = types.ModuleType("pycocotools.cocoeval")
    coco.COCO, cocoeval.COCOeval = COCO, COCOeval
    pkg.coco, pkg.cocoeval = coco, cocoeval
    return {"pycocotools": pkg, "pycocotools.coco": coco,
            "pycocotools.cocoeval": cocoeval}


def test_evaluate_with_pycocotools_as_odtpu(monkeypatch):
    from odtpu.eval import coco_eval as jcoco_eval
    from odtpu_torch.eval import coco_eval
    rows = [[42, 1.0, 2.0, 3.0, 4.0, 0.9, 7], [43, 5, 6, 7, 8, 0.5, 3]]
    for name in ("pycocotools", "pycocotools.coco", "pycocotools.cocoeval"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        coco_eval.evaluate_with_pycocotools(rows, "anno.json", (42, 43))
    results = []
    for fn in (coco_eval.evaluate_with_pycocotools,
               jcoco_eval.evaluate_with_pycocotools):
        calls = []
        for name, module in _stand_in_pycocotools(calls).items():
            monkeypatch.setitem(sys.modules, name, module)
        results.append((fn(rows, "anno.json", (42, 43)), calls))
    (got, got_calls), (want, want_calls) = results
    assert got == want and all(isinstance(v, float) for v in got)
    assert got_calls == want_calls
    assert ("imgIds", [42, 43]) in got_calls
    assert got_calls[1][:2] == ("loadRes", "float64")
