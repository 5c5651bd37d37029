"""The port's data parallelism (``odtpu_torch.parallel``) against
``odtpu``'s, on the CPU.

- ``allgather_host_rows`` is the identity in one process, and
  ``EvalVOC._scatter_rows`` places gathered rows as ``odtpu``'s does.
- The loader's shard: ``DetLoader(shard=(r, 2))`` yields ``odtpu``'s
  ``DetLoader(shard=(r, 2))`` batches on a tests/synth.py VOC tree (the
  uint8 transforms, so bit for bit), shuffled and augmented for train,
  in order for eval; a train shard keeps every rank at the same count
  of steps where ``odtpu``'s would give one rank a batch more.
- Two gloo processes on 127.0.0.1 (tests/torch_parallel_worker.py, 120
  s each) gather ragged rows in rank order; validate VOC and COCO with a
  perfect detector (mAP 1 on each rank, the one-process result, image
  and ``dropped`` counts summed); and take one float64 step, the
  photometric distortion on the device, of a narrow SSD300 (VGG16 at
  64x64), a narrow FSSD (its batch norm) and DRN_SSD (batch norms,
  and weights the loss does not reach), each on its rank's 2 of 4
  images, from weights whose batch norms are drawn at random. Each
  rank's metrics, parameters, momenta and running statistics equal the
  port's one-process step on the 4 images within 1e-9 (relative L2 a
  tensor, as ``chip_smoke.momentum_errors`` takes it), the two ranks
  hold equal ones (bit for bit, rank 1's by their sha256), and SSD
  and FSSD meet ``odtpu``'s float64 ``make_train_step`` on the 4 images
  (under tests/torch_family_parity.py ``odtpu_float64``) as
  tests/test_torch_train_narrow64.py holds it: num_pos equal, losses
  within rtol 1e-4, updates within 1e-3, running statistics within
  1e-5. ``odtpu``'s photometric draws are fed to every side, each rank
  its block of rows; the rows a rank draws itself are that block of the
  one-process draws.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtpu.data.augment import SSDAugmentation as JSSDAugmentation
from odtpu.data.loader import DetLoader as JDetLoader
from odtpu.data.voc import VOCDetection as JVOCDetection
from odtpu.eval.evaluator import EvalVOC as JEvalVOC
from odtpu.parallel import train as jtrain
from odtpu.utils.config import default_cfg as jdefault_cfg

import chip_smoke
from odtpu_torch import parallel
from odtpu_torch.data import dataset_factory
from odtpu_torch.data.augment import SSDAugmentation
from odtpu_torch.data.loader import DetLoader
from odtpu_torch.data.voc import VOCDetection
from odtpu_torch.eval.evaluator import EvalVOC, eval_solver_factory
from odtpu_torch.models import fssd, probe_layer_dims
from odtpu_torch.train_step import create_train_state
from odtpu_torch.utils.config import load_cfg

import torch_family_parity as fp
import torch_parallel_worker as worker
from synth import make_coco, make_voc
from test_torch_loss import jax_draws
from test_torch_train_families import _jax_model, tiny_cfg
from torch_tmp import drop_module_tmp  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = (("2007", "test"),)
TIMEOUT = 120
BATCH = 4  # the global batch of the steps: 2 a rank


def test_allgather_host_rows_is_the_identity_in_one_process():
    assert not parallel.initialized() and parallel.world() == 1
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(parallel.allgather_host_rows(rows), rows)
    assert parallel.allgather_host_rows(
        np.zeros((0, 7), np.float32)).shape == (0, 7)
    assert parallel.sum_over_ranks(3, 4) == (3, 4)
    with pytest.raises(ValueError, match="N, K"):
        parallel.allgather_host_rows(np.zeros(3, np.float32))


def test_scatter_rows_matches_odtpu():
    rng = np.random.RandomState(0)
    n = 300
    merged = np.concatenate([
        rng.randint(0, 5, (n, 1)), rng.randint(1, 4, (n, 1)),
        rng.rand(n, 5)], axis=1).astype(np.float32)
    solvers = []
    for cls in (EvalVOC, JEvalVOC):
        ev = cls.__new__(cls)  # no loader or cfg: only the results
        ev.loader = type("L", (), {"num_items": 5})()
        ev.num_classes = 4
        ev.reset_results()
        ev._scatter_rows(merged)
        solvers.append(ev)
    for cls in range(1, 4):
        for pos in range(5):
            np.testing.assert_array_equal(solvers[0].results[cls][pos],
                                          solvers[1].results[cls][pos])
    assert sum(len(r) for c in solvers[0].results for r in c) == n


@pytest.fixture(scope="module")
def voc8(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc8") / "VOCdevkit")
    make_voc(root, n_images=8, seed=3)
    return root


def _loaders(root, phase, shard, batch=2):
    train = phase == "train"
    kw = (dict(device_photometric=True) if train
          else dict(use_base=True, device_normalize=True))
    return [loader(ds(root, SETS), aug(**kw), batch_size=batch,
                   shuffle=train, drop_last=train, num_workers=2, seed=5,
                   shard=shard)
            for loader, ds, aug in ((DetLoader, VOCDetection,
                                     SSDAugmentation),
                                    (JDetLoader, JVOCDetection,
                                     JSSDAugmentation))]


@pytest.mark.parametrize("phase", ["train", "eval"])
@pytest.mark.parametrize("rank", [0, 1])
def test_loader_shard_matches_odtpu(voc8, phase, rank):
    loader, jloader = _loaders(voc8, phase, (rank, 2))
    assert len(loader) == len(jloader) == 2
    seen = []
    for _ in range(2 if phase == "train" else 1):  # two epochs: reshuffled
        for got, want in zip(loader, jloader):
            assert got["ids"] == want["ids"]
            assert got["images"].dtype == np.uint8
            for k in ("images", "boxes", "labels", "extra", "indices"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            seen.append(got["indices"].tolist())
    assert len(seen) == (4 if phase == "train" else 2)
    if phase == "eval":
        assert sum(seen, []) == list(range(rank, 8, 2))
    else:
        assert seen[:2] != seen[2:]


def test_train_shards_take_equal_steps(tmp_path):
    """7 images, batches of 2 a rank: odtpu's rank 0 holds 4 and takes 2
    steps, its rank 1 holds 3 and takes 1; every rank of the port keeps
    3 and takes 1, the first batch of odtpu's."""
    root = str(tmp_path / "VOCdevkit")
    make_voc(root, n_images=7, seed=4)
    for rank in (0, 1):
        loader, jloader = _loaders(root, "train", (rank, 2))
        assert len(loader) == 1 and len(jloader) == 2 - rank
        got, want = next(iter(loader)), next(iter(jloader))
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["images"], want["images"])


def _random_norms(model, seed=0):
    """Every batch norm's scale, bias and statistics drawn at random (at
    init a norm would be the identity in eval mode and its scale 1)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo in ((m.weight, 0.5), (m.bias, -0.5),
                              (m.running_mean, -0.5), (m.running_var, 0.5)):
                    t.copy_(torch.from_numpy(lo + rng.uniform(
                        size=t.shape)))


def _step_inputs(case, seed):
    """Float64 weights (float32 values), the global batch of 4 uint8
    images with GT and odtpu's photometric draws of update 0."""
    cfg = worker.step_cfg(case)
    state, _ = create_train_state(copy.deepcopy(cfg), "cpu", seed=seed)
    _random_norms(state.model, seed)
    weights = {k: v.double() if v.is_floating_point() else v
               for k, v in state.model.state_dict().items()}
    boxes, labels = fp.scale_boxes(cfg, probe_layer_dims(cfg), BATCH,
                                   extra=1)
    images = np.random.RandomState(seed).randint(
        0, 256, (BATCH, 64, 64, 3)).astype(np.uint8)
    with fp.odtpu_float64():  # the draws of odtpu's float64 step
        draws = jax_draws(jax.random.fold_in(jax.random.PRNGKey(17), 0),
                          BATCH)
    return {"weights": weights, "images": torch.from_numpy(images),
            "boxes": torch.from_numpy(boxes),
            "labels": torch.from_numpy(labels), "draws": draws}


def _odtpu_step(case, data):
    """odtpu's float64 step on the global batch from ``data``'s weights:
    (new state, metrics)."""
    with fp.odtpu_float64():
        jcfg = tiny_cfg(jdefault_cfg(), *worker.CASES[case])
        jcfg.TPU.COMPUTE_DTYPE = "float64"
        jcfg.DATASET.DEVICE_PHOTOMETRIC = True
        jmodel, jpriors = _jax_model(jcfg)
        v = fp.odtpu_variables(data["weights"])
        tx, _ = jtrain.make_optimizer(jcfg)
        jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                                   params=v["params"],
                                   opt_state=tx.init(v["params"]),
                                   batch_stats=v.get("batch_stats", {}))
        jstep = jtrain.make_train_step(jmodel, jpriors, jcfg, tx,
                                       donate=False)
        jnew, jm = jstep(jstate, jnp.asarray(data["images"].numpy()),
                         jnp.asarray(data["boxes"].numpy()),
                         jnp.asarray(data["labels"].numpy()))
        return jax.device_get((jnew, jm))


CASES = {"ssd": 0, "fssd": 1, "drnssd": 2}  # case -> seed
ODTPU_CASES = ("ssd", "fssd")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' results, the one-process steps and odtpu's steps,
    the jobs run side by side: the ranks in their processes, the rest
    here meanwhile."""
    work = tmp_path_factory.mktemp("two_ranks")
    job = {"voc": str(work / "voc" / "VOCdevkit"), "coco": str(work / "coco"),
           "cases": list(CASES)}
    make_voc(job["voc"], n_images=7, seed=11)
    make_coco(job["coco"], n_images=7, seed=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fssd, "FSSD300_PYRAMID", worker.TINY_PYRAMID)
        inputs = {case: _step_inputs(case, seed)
                  for case, seed in CASES.items()}
    for case, data in inputs.items():
        torch.save(data, str(work / (case + ".pt")))
    with open(work / "job.json", "w") as f:
        json.dump(job, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_parallel_worker.py"),
         str(work)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for r in range(2)]
    try:
        one = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fssd, "FSSD300_PYRAMID", worker.TINY_PYRAMID)
            for case, data in inputs.items():
                m, state, step = worker.one_step(
                    case, data["weights"], data["images"], data["boxes"],
                    data["labels"], data["draws"])
                one[case] = worker.step_result(m, state)
                one[case]["own_draws"] = step.aug_params(BATCH, 0)
        odtpu = {case: _odtpu_step(case, inputs[case])
                 for case in ODTPU_CASES}
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, "rank {} failed:\n{}".format(r, out)
        ranks = [torch.load(str(work / "rank{}.pt".format(r)),
                            weights_only=False) for r in range(2)]
    finally:
        for p in procs:
            p.kill()
        for f in work.glob("*.pt"):  # rank 0's file alone is about 1 GB
            f.unlink()
    return {"ranks": ranks, "one": one, "odtpu": odtpu, "job": job,
            "inputs": inputs}


@pytest.mark.parametrize("case", list(CASES))
def test_worker_cfg_is_the_narrow_tests_cfg(case):
    want = tiny_cfg(load_cfg(), *worker.CASES[case])
    want.TPU.COMPUTE_DTYPE = "float64"
    want.DATASET.DEVICE_PHOTOMETRIC = True
    assert worker.step_cfg(case) == want


def test_two_ranks_gather_rows_in_rank_order(two_ranks):
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    for out in two_ranks["ranks"]:
        assert (out["rank"], out["world"]) in ((0, 2), (1, 2))
        # rank 0 holds 3 rows, rank 1 none
        np.testing.assert_array_equal(out["gather_ragged"], rows)
        np.testing.assert_array_equal(
            out["gather_uneven"],
            np.repeat(np.float32([0, 1]), [2, 5])[:, None] * np.ones(4))


@pytest.mark.parametrize("name,key,sets", [
    ("ssd_vgg16_voc", "voc", SETS),
    ("ssd_vgg16_coco", "coco", (("2014", "val"),))])
def test_two_ranks_validate_the_one_process_map(two_ranks, tmp_path, name,
                                                key, sets):
    cfg = load_cfg(name)
    cfg.DATASET.DATASET_DIR = two_ranks["job"][key]
    cfg.DATASET.TEST_SETS = sets
    cfg.DATASET.EVAL_BATCH_SIZE, cfg.DATASET.NUM_WORKERS = 2, 1
    loader = dataset_factory("eval", cfg)
    solver = eval_solver_factory(loader, cfg, str(tmp_path))
    _, maps = solver.validate(worker.truth_step(
        loader.dataset, 2, list(range(7))))
    assert maps == pytest.approx([1.0] * len(maps), abs=1e-9)
    slices = []
    for out in two_ranks["ranks"]:
        got = out[key]
        assert got["maps"] == maps
        assert got["images"] == got["dropped"] == 7
        assert got["batches"] == 2
        slices.append(got["slice"])
    assert slices == [[0, 2, 4, 6], [1, 3, 5]]


def _rel_errors(got, want):
    return chip_smoke.momentum_errors(
        {k: v.double() for k, v in got.items()},
        {k: v.double() for k, v in want.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_equals_the_one_process_step(two_ranks, case):
    one = two_ranks["one"][case]
    r0, r1 = (out[case] for out in two_ranks["ranks"])
    for k in ("params", "momentum", "buffers"):  # rank 1 sent digests
        assert sorted(r0[k]) == sorted(r1[k]), k
        for name, v in r0[k].items():
            assert worker.digest(v) == r1[k][name], (k, name)
    for name, v in one["buffers"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(r0["buffers"][name], v, rtol=1e-9,
                                       atol=1e-12, err_msg=name)
        else:
            assert torch.equal(r0["buffers"][name], v), name
    for k in ("params", "momentum"):
        errors = _rel_errors(r0[k], one[k])
        worst = max(errors, key=errors.get)
        assert errors[worst] <= 1e-9, (k, worst, errors[worst])
    for k, v in one["metrics"].items():
        assert float(r0["metrics"][k]) == float(r1["metrics"][k])
        assert float(r0["metrics"][k]) == pytest.approx(float(v), rel=1e-9)
    # each rank's own draws: its block of the one-process draws
    for r, out in enumerate(two_ranks["ranks"]):
        for k, v in one["own_draws"].items():
            assert torch.equal(out[case]["own_draws"][k],
                               v[2 * r:2 * r + 2]), k
    if case == "drnssd":  # the layers past layer7 feed nothing
        unused = [k for k in one["params"] if k.startswith(tuple(
            "backbone.layer{}.".format(i) for i in range(8, 12)))]
        assert unused
        old = two_ranks["inputs"][case]["weights"]
        for k in unused:  # a zero gradient: weight decay alone moved them
            assert old[k].abs().sum() > 0, k
            assert torch.equal(r0["momentum"][k], one["momentum"][k]), k
            np.testing.assert_allclose(r0["momentum"][k], 5e-4 * old[k],
                                       rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", ODTPU_CASES)
def test_two_rank_step_meets_odtpu(two_ranks, case):
    jnew, jm = two_ranks["odtpu"][case]
    got = two_ranks["ranks"][0][case]
    assert int(got["metrics"]["num_pos"]) == int(jm["num_pos"]) > 0
    for k in ("loss", "loss_loc", "loss_conf"):
        assert float(got["metrics"][k]) == pytest.approx(float(jm[k]),
                                                         rel=1e-4), k
    from odtpu_torch.utils.checkpoint import from_odtpu_params
    want = from_odtpu_params(fp._momentum(jnew.opt_state))
    errors = _rel_errors(got["momentum"], want)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= 1e-3, (worst, errors[worst])
    stats = {k: v for k, v in got["buffers"].items()
             if k.endswith(("running_mean", "running_var"))}
    want = from_odtpu_params(fp.flat_variables(
        {"batch_stats": jnew.batch_stats}) if jnew.batch_stats else {})
    assert bool(stats) == (case == "fssd") and sorted(stats) == sorted(want)
    if stats:
        errors = chip_smoke.stats_errors(
            {k: v.double() for k, v in stats.items()},
            {k: torch.as_tensor(np.asarray(v)).double()
             for k, v in want.items()})
        worst = max(errors, key=errors.get)
        assert errors[worst] <= 1e-5, (worst, errors[worst])
    # the reading PERF.md quotes (pytest -s)
    print("{}: two ranks against odtpu's float64 step, largest update "
          "error {:.3g}".format(case, max(_rel_errors(
              got["momentum"], from_odtpu_params(
                  fp._momentum(jnew.opt_state))).values())))
