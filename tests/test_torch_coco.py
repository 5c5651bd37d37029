"""The port's COCO data and evaluator against ``odtpu`` on the CPU.

Tolerances, and why:
- ``COCODetection`` items, the eval loader's batches: equal (the same
  parse and arithmetic);
- ``evaluate_coco`` on ``tests/test_coco_oracle.py``'s random scenarios:
  equal to ``odtpu``'s (abs 1e-12, the same float64 numpy arithmetic);
- ``EvalCOCO`` fed the ground truth as its rows: mAP@0.5 and
  mAP@[.5:.95] of 1.0 within 1e-9.
"""

import numpy as np
import pytest
import torch

from odtpu.data import COCODetection as JCOCODetection
from odtpu.data import dataset_factory as jdataset_factory
from odtpu.eval.coco_eval import build_gt_index as jbuild_gt_index
from odtpu.eval.coco_eval import evaluate_coco as jevaluate_coco
from odtpu.utils.config import load_cfg as jload_cfg

from odtpu_torch.data import COCODetection, dataset_factory
from odtpu_torch.eval.coco_eval import build_gt_index, evaluate_coco
from odtpu_torch.eval.evaluator import EvalCOCO, EvalVOC, eval_solver_factory
from odtpu_torch.utils.config import load_cfg

from chip_smoke import truth_step
from synth import make_coco
from test_coco_oracle import _random_scenario

torch.set_num_threads(2)

SETS = (("2014", "val"),)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_coco(root, n_images=7, seed=9)
    return root


def _cfgs(root, num_pics=0, batch=3):
    cfg, jcfg = load_cfg("ssd_vgg16_coco"), jload_cfg(
        "cfgs/base/ssd_vgg16_coco.yml")
    for c in (cfg, jcfg):
        c.DATASET.DATASET_DIR = root
        c.DATASET.TEST_SETS = SETS
        c.DATASET.EVAL_BATCH_SIZE = batch
        c.DATASET.NUM_WORKERS = 2
        c.DATASET.NUM_EVAL_PICS = num_pics
    return cfg, jcfg


def test_coco_detection_matches_odtpu(coco):
    ds, jds = COCODetection(coco, SETS), JCOCODetection(coco, SETS)
    assert len(ds) == len(jds) == 7
    assert ds.cat_to_label == jds.cat_to_label
    assert ds.label_to_cat == jds.label_to_cat
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert got["img_id"] == want["img_id"]
        for k in ("image", "boxes", "labels", "extra"):
            np.testing.assert_array_equal(got[k], want[k])
    assert build_gt_index(ds) == jbuild_gt_index(jds)


def test_coco_eval_loader_matches_odtpu(coco):
    cfg, jcfg = _cfgs(coco)
    loader, jloader = dataset_factory("eval", cfg), jdataset_factory(
        "eval", jcfg)
    assert len(loader) == len(jloader) == 3
    for got, want in zip(loader, jloader):
        assert got["ids"] == want["ids"]
        for k in ("images", "boxes", "labels", "extra"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", range(20))
def test_evaluate_coco_matches_odtpu(seed):
    rng = np.random.RandomState(1234 + seed)
    det_rows, gt_index, cats = _random_scenario(rng)
    got = evaluate_coco(det_rows, gt_index, cats)
    want = jevaluate_coco(det_rows, gt_index, cats)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert all(0.0 <= m <= 1.0 for m in got)


@pytest.mark.parametrize("num_pics", [0, 4])
def test_eval_coco_scores_the_ground_truth_one(coco, num_pics):
    cfg, _ = _cfgs(coco, num_pics)
    loader = dataset_factory("eval", cfg)
    solver = eval_solver_factory(loader, cfg)
    assert isinstance(solver, EvalCOCO)
    rows, maps = solver.validate(truth_step(loader.dataset, 3))
    np.testing.assert_allclose(maps, [1.0, 1.0], rtol=0, atol=1e-9)
    assert solver.last_timing["images"] == (num_pics or 7)
    assert {r[0] for r in rows} == {
        float(loader.dataset.items[i][1]) for i in range(num_pics or 7)}


def test_eval_coco_rows_match_odtpu_evaluator(coco):
    """The same seeded random detections through the port's EvalCOCO and
    odtpu's give the same rows and mAP."""
    from odtpu.eval.evaluator import EvalCOCO as JEvalCOCO
    cfg, jcfg = _cfgs(coco)
    loader, jloader = dataset_factory("eval", cfg), jdataset_factory(
        "eval", jcfg)
    solver, jsolver = EvalCOCO(loader, cfg), JEvalCOCO(jloader, jcfg)
    rng = np.random.RandomState(0)
    solver.reset_results()
    jsolver.reset_results()
    for batch in loader:
        n = len(batch["ids"])
        det = np.zeros((n, 30, 6), np.float32)
        det[:, :, 0] = rng.uniform(0, 1, (n, 30))
        det[:, :, 1:3] = rng.uniform(0, 200, (n, 30, 2))
        det[:, :, 3:5] = det[:, :, 1:3] + rng.uniform(5, 80, (n, 30, 2))
        det[:, :, 5] = rng.randint(1, len(solver.label_to_cat) + 1,
                                   (n, 30))
        det[:, 25:, 0] = 0  # empty rows are skipped
        solver.accumulate(det, batch["extra"], batch["ids"], 0)
        jsolver.accumulate(det, batch["extra"], batch["ids"], 0)
    assert solver.rows == jsolver.rows and len(solver.rows) == 7 * 25
    assert solver.evaluate_stats()[1] == jsolver.evaluate_stats()[1]


def test_eval_solver_factory_picks_voc_for_voc():
    cfg = load_cfg("ssd_vgg16_voc")

    class Loader:
        batch_size, num_items = 2, 0

    assert isinstance(eval_solver_factory(Loader(), cfg), EvalVOC)
