"""The port's tensor-parallel and spatial meshes (``odtpu_torch.parallel``
``mesh`` and ``spatial``, ``models.shard_model``) against one process
and against ``odtpu``'s GSPMD mesh, on the CPU.

- The slab rule and every H-local op, in one process: each spatial
  rank's output rows, computed from its slab with the rows it would
  fetch, concatenated, equal the op on the whole map within 1e-12
  (float64), for every H in {1, 3, 5, 10, 19, 38, 75} and S in {2, 4}:
  convs with stride 2 (padding 1), dilation 6 (padding 6) and a 3x1
  kernel, the ceil-mode 2x2/2 pool, the 3x3/1 pool with padding 1, the
  bilinear upsample (to the next height of the list) and the heads'
  gather.
- Gloo processes on 127.0.0.1 (tests/torch_mesh_worker.py) at layouts
  (D, M, S) = (1, 2, 1), (1, 1, 2) and (1, 2, 2), the tensor-parallel
  threshold lowered to 64 channels, ``odtpu``'s photometric draws: one
  float64 step of the narrow SSD (VGG16 at 64x64) and of the narrow FSSD
  (batch norm and upsample) of tests/test_torch_train_families.py, each
  equal to the port's one-process step (metrics, parameters, momenta and
  running statistics, gathered, within 1e-9 relative L2 a tensor), and
  the eval step's gathered loc and conf (1e-9) and its rows (rtol 1e-4,
  atol 1e-5) equal the one process's.
- At (1, 1, 2) and (1, 2, 1), in processes of their own
  (tests/torch_mesh_odtpu_worker.py), ``odtpu``'s float64
  ``make_train_step`` and ``make_eval_step`` on a JAX CPU mesh of the
  same shape (its threshold lowered to 64 too): FSSD's step at
  tests/test_torch_train_narrow64.py's limits (num_pos equal, the losses
  within rtol 1e-4, every update within 1e-3 and every running
  statistic within 1e-5), and SSD's eval rows at rtol 1e-4 and atol
  1e-5 (``odtpu``'s own tests/test_parallel.py:136-139). At (1, 2, 2)
  ``odtpu``'s float64 mesh step leaves its own unsharded step (FSSD's
  loss 20.96 against 20.93) where its float32 steps agree, so that
  layout is held to the port's one process only.
- At (1, 2, 2), FSSD's step with the model ranks' replicated activations
  off by rounding-sized amounts: every replicated parameter, momentum
  and running statistic is bit-equal on every rank after it.
- A checkpoint saved at (1, 2, 1) (the blocks gathered, full tensors
  written) restores at world 1 and at (1, 1, 2), and the next step
  equals the uninterrupted one within 1e-9.
- The one-process entry points refuse a mesh with a message, a mesh
  that does not make up the world raises, and int8 serving and
  ``TPU.REMAT`` are refused on a sharded mesh.
"""

import copy
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from odtpu_torch import models, parallel
from odtpu_torch.models import fpn, fssd, probe_layer_dims
from odtpu_torch.parallel import spatial
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.eval_step import make_eval_step
from odtpu_torch.utils.checkpoint import Checkpointer
from odtpu_torch.utils.config import default_cfg, load_cfg, refuse_mesh

import torch_family_parity as fp
import torch_mesh_worker as mw
import torch_parallel_worker as pw
from test_torch_loss import jax_draws
from test_torch_parallel import _random_norms as random_norms
from torch_tmp import drop_module_tmp  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("1x2x1", "1x1x2", "1x2x2")
ODTPU_LAYOUTS = ("1x1x2", "1x2x1")  # held to odtpu's mesh as well
CASES = {"ssd": 0, "fssd": 1}  # case -> seed
BATCH = 2
TIMEOUT = 150
HEIGHTS = (1, 3, 5, 10, 19, 38, 75)


# --- the slabs and the H-local ops, in one process ---

def test_slab_rule():
    for h in HEIGHTS:
        for n in (1, 2, 4):
            rows = [spatial.slab(h, n, i) for i in range(n)]
            assert rows[0][0] == 0 and rows[-1][1] == h
            assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
            c = -(-h // n)
            assert [r1 - r0 for r0, r1 in rows] == [
                min(c, max(0, h - i * c)) for i in range(n)]
    assert spatial.slab(1, 2, 1) == (1, 1)  # SSD300's last map at S = 2
    assert [spatial.slab(19, 4, i) for i in range(4)] == [
        (0, 5), (5, 10), (10, 15), (15, 19)]
    # conv6's dilation-6 window on a 5-row slab reaches 6 rows each way
    assert spatial.window(5, 10, 3, 1, 6, 6) == (-1, 16)


class _Ranks:
    """Spatial rank ``s`` of ``n`` in one process: the mesh, and the
    fetch and all-gather served from the whole map."""

    def __init__(self, monkeypatch, n, s, full):
        self.n, self.s = n, s
        mesh = parallel.Mesh(n, s, torch.device("cpu"), 1, 1, n)
        for owner in (parallel, parallel.mesh):
            monkeypatch.setattr(owner, "current", lambda: mesh)
        monkeypatch.setattr(spatial, "fetch", lambda x, h, need: full[
            :, :, need[s][0]:need[s][1]])

        def gather(x, axis):
            c = -(-full.shape[2] // n)
            return [F.pad(full[:, :, slice(*spatial.slab(
                full.shape[2], n, t))], (0, 0, 0, c - (
                    spatial.slab(full.shape[2], n, t)[1]
                    - spatial.slab(full.shape[2], n, t)[0])))
                for t in range(n)]

        monkeypatch.setattr(parallel.mesh, "all_gather", gather)


def _conv(weight, stride, padding, dilation):
    def op(x, size=None):
        return spatial.conv2d(x, weight, None, stride, padding, dilation)
    return op


NEXT = {1: 3, 3: 5, 5: 10, 10: 19, 19: 38, 38: 75, 75: 38}
_W = torch.randn(3, 2, 3, 3, dtype=torch.float64,
                 generator=torch.Generator().manual_seed(0))
OPS = {
    "conv_stride2": _conv(_W, 2, 1, 1),
    "conv_dilation6": _conv(_W, 1, 6, 6),
    "conv_3x1": _conv(_W[:, :, :, :1], 1, (1, 0), 1),
    "pool_ceil": lambda x, size=None: spatial.max_pool2d(x, 2, 2, 0, True),
    "pool_3x1_pad1": lambda x, size=None: spatial.max_pool2d(x, 3, 1, 1,
                                                             False),
    "upsample": lambda x, size: fpn.upsample_bilinear(x, size),
    "gather": lambda x, size=None: spatial.gather_rows(x),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", list(OPS))
def test_h_local_op_equals_the_whole_map(monkeypatch, op, n):
    fn = OPS[op]
    for h in HEIGHTS:
        full = torch.randn(2, 2, h, 5, dtype=torch.float64,
                           generator=torch.Generator().manual_seed(h))
        size = (NEXT[h], 7)
        with spatial.record(h) as plan:
            want = fn(full, size)
        assert len(plan.ops) == 1, plan.ops
        parts = []
        for s in range(n):
            with monkeypatch.context() as mp:
                _Ranks(mp, n, s, full)
                r0, r1 = spatial.slab(h, n, s)
                with spatial.replay(plan):
                    parts.append(fn(full[:, :, r0:r1], size))
        if op == "gather":  # every rank holds the whole map
            for got in parts:
                assert torch.equal(got, want), (h, n)
            continue
        h_out = plan.ops[0][2]
        assert [p.shape[2] for p in parts] == [
            b - a for a, b in (spatial.slab(h_out, n, s) for s in range(n))]
        got = torch.cat(parts, 2)
        assert got.shape == want.shape, (h, n, got.shape, want.shape)
        assert torch.allclose(got, want, rtol=0, atol=1e-12), (h, n)


def test_a_plan_off_its_forward_raises(monkeypatch):
    x = torch.zeros(1, 2, 10, 5, dtype=torch.float64)
    with spatial.record(10) as plan:
        OPS["conv_stride2"](x)
    _Ranks(monkeypatch, 2, 0, x)
    with pytest.raises(RuntimeError, match="off its plan"):
        with spatial.replay(plan):
            OPS["pool_ceil"](x[:, :, :5])
    with pytest.raises(RuntimeError, match="used 0 of"):
        with spatial.replay(plan):
            pass


# --- the mesh runs ---

def _inputs(case, seed, draws):
    """Float64 weights (float32 values, batch norms drawn at random, the
    first conv divided by 64), the global batch of 2 uint8 images with
    GT, and the photometric parameters ``draws``."""
    cfg = pw.step_cfg(case)
    state, _ = create_train_state(copy.deepcopy(cfg), "cpu", seed=seed)
    random_norms(state.model, seed)
    weights = {k: v.double() if v.is_floating_point() else v
               for k, v in state.model.state_dict().items()}
    # the raw pixels' scale taken out, as infer.random_state_dict does, so
    # that the boxes decode finite
    weights["backbone.conv1_1.conv.weight"] /= 64
    boxes, labels = fp.scale_boxes(cfg, probe_layer_dims(cfg), BATCH,
                                   extra=1)
    images = np.random.RandomState(seed).randint(
        0, 256, (BATCH, 64, 64, 3)).astype(np.uint8)
    return {"weights": weights, "images": torch.from_numpy(images),
            "boxes": torch.from_numpy(boxes),
            "labels": torch.from_numpy(labels), "draws": draws}


def _one_process(case, data, steps=1):
    """The port's one-process eval and steps from ``data``'s weights;
    with ``steps``, also the step under ``TPU.REMAT`` from the same
    weights and the float32 int8 eval."""
    cfg = pw.step_cfg(case)
    state, priors = create_train_state(cfg, "cpu")
    state.model.double()
    state.model.load_state_dict(data["weights"])
    ev = make_eval_step(state.model, priors.double(), cfg)
    outputs = ev.forward(data["images"])
    out = {"eval": {"outputs": outputs, "rows": ev.detect(*outputs)["rows"]}}
    step = make_train_step(priors.double(), cfg)
    for key in ("step", "next")[:steps]:
        out[key] = pw.step_result(mw.step_on(state, step, data), state)
    if steps:
        cfg = pw.step_cfg(case)
        cfg.TPU.REMAT = True
        remat, priors = create_train_state(cfg, "cpu")
        remat.model.double()
        remat.model.load_state_dict(data["weights"])
        out["remat"] = pw.step_result(mw.step_on(
            remat, make_train_step(priors.double(), cfg), data), remat)
        cfg.TPU.COMPUTE_DTYPE, cfg.TPU.QUANT = "float32", "int8"
        served, priors = create_train_state(cfg, "cpu")
        served.model.load_state_dict({k: v.float() if v.is_floating_point()
                                      else v
                                      for k, v in data["weights"].items()})
        out["int8"] = mw.eval_result(served, priors, cfg, data["images"])
    return out, state, step


def _free_ports(n):
    """``n`` distinct free ports on 127.0.0.1."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _launch(work, layout, port):
    w = int(np.prod(mw.layout_of(layout)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(w), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"),
         str(work), layout], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for r in range(w)]


def _launch_odtpu(work, layout):
    """tests/torch_mesh_odtpu_worker.py at ``layout``: odtpu's side."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_mesh_odtpu_worker.py"),
         str(work), layout], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO)]


def run_meshes(work, inputs, layouts, resume, odtpu=()):
    """Start the ranks of each of ``layouts`` on ``inputs`` (written to
    ``work``), the checkpoint case ``resume``, and odtpu's side at each of
    the layouts ``odtpu`` (as ``odtpu_<layout>``); returns the processes
    for :func:`finish`."""
    for case, data in inputs.items():
        torch.save(data, str(work / (case + ".pt")))
    torch.save({"cases": list(inputs), "resume": resume},
               str(work / "job.pt"))
    procs = {layout: _launch(work, layout, port)
             for layout, port in zip(layouts, _free_ports(len(layouts)))}
    procs.update({"odtpu_" + layout: _launch_odtpu(work, layout)
                  for layout in odtpu})
    return procs


def finish(work, procs):
    """Wait for the launches; their results by name."""
    try:
        for layout, ps in procs.items():
            for r, p in enumerate(ps):
                out = p.communicate(timeout=TIMEOUT)[0]
                assert p.returncode == 0, "{} rank {} failed:\n{}".format(
                    layout, r, out[-4000:])
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    return {layout: torch.load(str(work / (layout + ".pt")),
                               weights_only=False) for layout in procs}


def one_process(inputs, resume=None):
    """The one-process results of every case (two steps of ``resume``),
    the states built without their seeded init (the weights are loaded
    over it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fssd, "FSSD300_PYRAMID", pw.TINY_PYRAMID)
        mp.setattr(models, "init_weights", lambda model, seed: None)
        return {case: _one_process(case, data, 2 if case == resume else 1)[0]
                for case, data in inputs.items()}


def make_inputs(draws):
    """Every case's :func:`_inputs`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fssd, "FSSD300_PYRAMID", pw.TINY_PYRAMID)
        return {case: _inputs(case, seed, draws)
                for case, seed in CASES.items()}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every layout's results, odtpu's at :data:`ODTPU_LAYOUTS`, the
    one-process ones and the world-1 resume: the ranks and odtpu in their
    processes, the one process here meanwhile."""
    work = tmp_path_factory.mktemp("meshes")
    with fp.odtpu_float64():
        draws = jax_draws(jax.random.fold_in(jax.random.PRNGKey(17), 0),
                          BATCH)
    inputs = make_inputs(draws)
    procs = run_meshes(work, inputs, LAYOUTS, "ssd", ODTPU_LAYOUTS)
    try:
        one = one_process(inputs, "ssd")
    finally:
        ranks = finish(work, procs)
    # the checkpoint of 1x2x1, restored in one process
    _, state, step = _one_process("ssd", inputs["ssd"], 0)
    Checkpointer(str(work / "ckpt")).restore(state)
    resumed = pw.step_result(mw.step_on(state, step, inputs["ssd"]), state)
    return {"ranks": ranks, "one": one, "inputs": inputs,
            "resumed": resumed, "ckpt": work / "ckpt"}


def _rel_errors(got, want):
    return chip_smoke.momentum_errors(
        {k: v.double() for k, v in got.items()},
        {k: v.double() for k, v in want.items()})


def _hold_step(got, want, limit=1e-9):
    for k in ("params", "momentum"):
        errors = _rel_errors(got[k], want[k])
        assert sorted(errors) == sorted(want[k])
        worst = max(errors, key=errors.get)
        assert errors[worst] <= limit, (k, worst, errors[worst])
    floats = {k: v for k, v in want["buffers"].items()
              if v.is_floating_point()}
    if floats:
        errors = _rel_errors({k: got["buffers"][k] for k in floats}, floats)
        worst = max(errors, key=errors.get)
        assert errors[worst] <= limit, ("buffers", worst, errors[worst])
    for k, v in want["metrics"].items():
        assert float(got["metrics"][k]) == pytest.approx(float(v), rel=1e-9)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_step_equals_the_one_process_step(meshes, layout, case):
    res = meshes["ranks"][layout]
    mesh = res["mesh"]
    assert (mesh.data, mesh.model, mesh.spatial) == mw.layout_of(layout)
    _hold_step(res[case]["step"], meshes["one"][case]["step"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_eval_equals_one_process(meshes, layout, case):
    got, want = meshes["ranks"][layout][case]["eval"], \
        meshes["one"][case]["eval"]
    for g, w in zip(got["outputs"], want["outputs"]):
        assert g.shape == w.shape
        assert float((g - w).norm() / w.norm()) <= 1e-9
    rows = want["rows"].numpy()
    assert (rows[..., 0] > 0).sum() > 0
    np.testing.assert_allclose(got["rows"].numpy(), rows, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("where", ["world1", "1x1x2"])
def test_checkpoint_crosses_layouts(meshes, where):
    """Saved at (1, 2, 1): full tensors on disk; the next step taken at
    world 1 or at (1, 1, 2) equals the uninterrupted one at (1, 2, 1)."""
    data = Checkpointer(str(meshes["ckpt"])).read()
    weights = meshes["inputs"]["ssd"]["weights"]
    assert {k: tuple(v.shape) for k, v in data["model"].items()} == {
        k: tuple(v.shape) for k, v in weights.items()}
    _hold_step(meshes["ranks"]["1x2x1"]["ssd"]["next"],
               meshes["one"]["ssd"]["next"])
    got = (meshes["resumed"] if where == "world1"
           else meshes["ranks"]["1x1x2"]["resumed"])
    _hold_step(got, meshes["ranks"]["1x2x1"]["ssd"]["next"])


@pytest.mark.parametrize("layout", ODTPU_LAYOUTS)
def test_mesh_step_meets_odtpu_mesh(meshes, layout):
    _meets_odtpu(meshes["ranks"][layout]["fssd"]["step"],
                 meshes["ranks"]["odtpu_" + layout])


def _meets_odtpu(got, odtpu):
    """A float64 FSSD step against ``odtpu``'s at the narrow64 limits."""
    jm, want = odtpu["metrics"], odtpu["momentum"]
    assert int(got["metrics"]["num_pos"]) == int(jm["num_pos"]) > 0
    for k in ("loss", "loss_loc", "loss_conf"):
        assert float(got["metrics"][k]) == pytest.approx(float(jm[k]),
                                                         rel=1e-4), k
    errors = chip_smoke.momentum_errors(
        {k: v.double() for k, v in got["momentum"].items()},
        {k: v.double() for k, v in want.items()})
    worst = max(errors, key=errors.get)
    assert errors[worst] <= 1e-3, (worst, errors[worst])
    want = odtpu["stats"]
    assert want
    errors = chip_smoke.stats_errors(
        {k: got["buffers"][k].double() for k in want},
        {k: v.double() for k, v in want.items()})
    worst = max(errors, key=errors.get)
    assert errors[worst] <= 1e-5, (worst, errors[worst])


@pytest.mark.parametrize("layout", ODTPU_LAYOUTS)
def test_mesh_eval_rows_meet_odtpu_mesh(meshes, layout):
    got = meshes["ranks"][layout]["ssd"]["eval"]["rows"].numpy()
    want = meshes["ranks"]["odtpu_" + layout]["rows"].numpy()
    assert (want[..., 0] > 0).sum() > 0
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_replicated_tensors_stay_one_value(meshes):
    """FSSD's step at (1, 2, 2) with the outputs of ``transform_0`` and
    ``pyramid_0`` off by (m + 1) * 1e-6 on model rank m
    (tests/torch_mesh_worker.py): the replicated parameters, momenta and
    running statistics are bit-equal on every rank, and the offset
    reached the fusion norm's statistics."""
    res = meshes["ranks"]["1x2x2"]
    digests = res["perturbed"]["digests"]
    assert len(digests) == 4 and "fusion_bn.running_mean" in digests[0]
    assert any(k.startswith("head.") for k in digests[0])
    for r, d in enumerate(digests):
        assert d == digests[0], (r, sorted(
            k for k in d if d[k] != digests[0][k]))
    assert not torch.equal(res["perturbed"]["running_mean"], res["fssd"][
        "step"]["buffers"]["fusion_bn.running_mean"])


# --- TPU.REMAT and int8 serving on the meshes ---

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_remat_step_equals_the_step_without_it(meshes, layout, case):
    """Within 1e-12; at S = 2 the recompute fetches every halo of the
    forward again (its bytes equal the forward's), none without remat,
    and the backward's are the same."""
    res = meshes["ranks"][layout][case]
    _hold_step(res["remat"], res["step"], limit=1e-12)
    plain, remat = res["step"]["sent"], res["remat"]["sent"]
    assert plain["recompute"] == 0
    assert remat["recompute"] == remat["forward"] == plain["forward"]
    assert remat["backward"] == plain["backward"]
    assert (plain["forward"] > 0) == (mw.layout_of(layout)[2] > 1)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_remat_step_equals_one_process(meshes, layout, case):
    _hold_step(meshes["ranks"][layout][case]["remat"],
               meshes["one"][case]["remat"])


def test_mesh_remat_step_meets_odtpu_mesh(meshes):
    """FSSD's remat step at (1, 1, 2) against ``odtpu``'s remat step on
    its mesh of the same shape."""
    _meets_odtpu(meshes["ranks"]["1x1x2"]["fssd"]["remat"],
                 meshes["ranks"]["odtpu_1x1x2"]["remat"])


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_int8_equals_one_process_bit_for_bit(meshes, case):
    """int8 serving at (1, 2, 1) in float32: the gathered loc and conf and
    the rows equal one process's int8 bit for bit."""
    got = meshes["ranks"]["1x2x1"][case]["int8"]
    want = meshes["one"][case]["int8"]
    for g, w in zip(got["outputs"], want["outputs"]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert (want["rows"][..., 0] > 0).sum() > 0
    assert torch.equal(got["rows"], want["rows"])


@pytest.mark.parametrize("case", list(CASES))
def test_odtpu_int8_mesh_rows_meet_its_unsharded_rows(meshes, case):
    """``odtpu``'s jitted int8 eval step at (1, 2, 1) against its own
    unsharded jitted int8 step: rtol 1e-4, atol 1e-5. With the port's
    one process held to ``odtpu``'s eager int8 (test_torch_quant.py) and
    the port's mesh to its one process (above), this closes the chain."""
    odtpu = meshes["ranks"]["odtpu_1x2x1"]["int8"][case]
    want = odtpu["one"].numpy()
    assert (want[..., 0] > 0).sum() > 0
    np.testing.assert_array_equal(odtpu["mesh"].numpy()[..., 5],
                                  want[..., 5])
    np.testing.assert_allclose(odtpu["mesh"].numpy(), want, rtol=1e-4,
                               atol=1e-5)


# --- what a mesh is refused ---

def _mesh_cfg(model=2, spatial_=1):
    cfg = default_cfg()
    cfg.TPU.MESH_MODEL, cfg.TPU.MESH_SPATIAL = model, spatial_
    return cfg


@pytest.mark.parametrize("entry", ["serve", "export", "train_debug",
                                   "detector"])
def test_one_process_entry_points_refuse_a_mesh(entry):
    from odtpu_torch import export, infer, serve, train_debug
    cfg = _mesh_cfg(*((2, 1) if entry in ("serve", "detector") else (1, 2)))
    key = "MESH_MODEL" if entry in ("serve", "detector") else "MESH_SPATIAL"
    call = {"serve": lambda: serve.build_engine(cfg, device="cpu"),
            "export": lambda: export.export_artifact("x.zip", cfg=cfg,
                                                     device="cpu"),
            "train_debug": lambda: train_debug.run(cfg, device="cpu"),
            "detector": lambda: infer.Detector(cfg, device="cpu")}[entry]
    with pytest.raises(ValueError, match="TPU.{} = 2: .* runs in one "
                                         "process".format(key)):
        call()


def test_a_mesh_must_make_up_the_world():
    assert not parallel.initialized()
    with pytest.raises(ValueError, match="x 2 x 1 but the run has 1 "):
        parallel.make_mesh(_mesh_cfg(2, 1))
    with pytest.raises(ValueError, match="positive integer"):
        parallel.make_mesh(_mesh_cfg(0, 1))
    cfg = load_cfg()  # the cfg no longer refuses the axes themselves
    cfg.TPU.MESH_MODEL = cfg.TPU.MESH_SPATIAL = 2
    assert parallel.mesh_sizes(cfg, 8) == (2, 2, 2)
    assert parallel.mesh_sizes(cfg, 4) == (1, 2, 2)
    mesh = parallel.Mesh(8, 5, torch.device("cpu"), 2, 2, 2)
    assert (mesh.d, mesh.m, mesh.s) == (1, 0, 1)
    assert mesh.ranks("model") == [5, 7]
    assert mesh.ranks("spatial") == [4, 5]
    assert mesh.ranks("data") == [1, 5]
    assert mesh.ranks("replica") == [0, 1, 4, 5]
    refuse_mesh(load_cfg(), "x")  # 1 and 1 pass


def test_int8_is_refused_on_a_spatial_mesh(monkeypatch):
    """At (1, 1, 2) with a message that quotes ``odtpu``'s own compile
    failure; at (1, 2, 1) int8 is laid out."""
    cfg = load_cfg()
    cfg.TPU.QUANT = "int8"
    for model, spatial_, refused in ((1, 2, True), (2, 1, False)):
        mesh = parallel.Mesh(2, 0, torch.device("cpu"), 1, model, spatial_)
        for owner in (parallel, parallel.mesh):
            monkeypatch.setattr(owner, "current", lambda: mesh)
        cfg.TPU.MESH_MODEL, cfg.TPU.MESH_SPATIAL = model, spatial_
        if not refused:
            assert models.shard_model(torch.nn.Identity(), cfg).tp_keys == {}
            continue
        with pytest.raises(NotImplementedError, match="MESH_SPATIAL = 2: "
                           "odtpu's own int8 eval step does not compile .*"
                           "The element types of the operands to Pad do "
                           "not match"):
            models.shard_model(torch.nn.Identity(), cfg)
