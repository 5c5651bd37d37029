"""The harness on the CPU at a tiny size: SSD300 and RFBNet512 at their
published widths with batches of 2 images in float32, the look for a
card skipped. The program agrees with the reference; every fault a cell
can have, planted under the timed path, turns ``correct`` false; the
run itself refuses a machine with no card."""

import ast
import subprocess
import sys
import time

import pytest
import torch

from benchmark import cells, compare, serve, train, yardstick

SEED = 2**31 + 4321


def tiny(name: str) -> dict:
    cell = cells.load(name)
    cfg = cell["config"]
    cfg["compute_dtype"] = "float32"
    cfg["port_cfg_changes"]["TPU.COMPUTE_DTYPE"] = "float32"
    cell["traffic"].update(batch=2, host_batches=3, warmup_batches=1,
                           check_batches=2, reference_steps=2,
                           warmup_steps=0)
    return cell


def run(name: str, seconds: float = 0.5) -> tuple[bool, dict]:
    cell = tiny(name)
    driver = serve if cell["traffic"]["driver"] == "serve" else train
    out = driver.run(cell, SEED, seconds, False, "cpu", time.time())
    ok, table = compare.verdict(out["numbers"], cell["config"]["limits"][
        cell["traffic"]["driver"]])
    return ok and out["failed"] == 0, out["numbers"]


@pytest.mark.parametrize("name", ["ssd300_vgg16_voc.serve_b32",
                                  "rfbnet512_vgg16_voc.serve_b32"])
def test_serve_agrees_with_reference(name):
    ok, numbers = run(name)
    assert ok, numbers
    assert max(numbers.values()) < 1e-4, numbers


@pytest.mark.parametrize("name", ["ssd300_vgg16_voc.train_b32",
                                  "rfbnet512_vgg16_voc.train_b32"])
def test_train_agrees_with_reference(name):
    ok, numbers = run(name)
    assert ok, numbers
    # two updates of two images: hard-negative mining amplifies float32
    # round-off into the second update of small leaves
    assert numbers["loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-3


def _half_rows(out):
    rows, dropped = out["rows"].clone(), out["dropped"].clone()
    b = rows.shape[0]
    rows[b // 2:] = 0
    dropped[b // 2:] = 0
    return {"rows": rows, "dropped": dropped}


def _altered_row(out):
    rows = out["rows"].clone()
    rows[0, 0, 5] = rows[0, 0, 5] % 20 + 1  # another class
    return {"rows": rows, "dropped": out["dropped"]}


@pytest.mark.parametrize("fault", [_half_rows, _altered_row])
def test_serve_faults_fail(monkeypatch, fault):
    from odtpu_torch.eval_step import EvalStep
    detect = EvalStep.detect

    def broken(self, *outputs):
        with torch.inference_mode():
            return fault(detect(self, *outputs))

    monkeypatch.setattr(EvalStep, "detect", broken)
    ok, numbers = run("ssd300_vgg16_voc.serve_b32")
    assert not ok, numbers


def _unchanged(monkeypatch):
    from odtpu_torch.train_step import TrainStep
    monkeypatch.setattr(TrainStep, "update", lambda self, state: None)


def _half_batch(monkeypatch):
    from odtpu_torch.train_step import TrainStep
    call = TrainStep.__call__

    def half(self, state, images, boxes, labels, aug_params=None):
        n = images.shape[0] // 2
        return call(self, state, images[:n], boxes[:n], labels[:n])

    monkeypatch.setattr(TrainStep, "__call__", half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_train_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    ok, numbers = run("ssd300_vgg16_voc.train_b32")
    assert not ok, numbers


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "ssd300_vgg16_voc.serve_b32", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], cwd=cells.ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_and_no_odtpu():
    for path in cells.HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "odtpu"}, path
    for path in (cells.HERE / "reference").rglob("*.py"):
        assert "odtpu_torch" not in _imports(path), path


def test_no_jax_loaded_by_a_run():
    """A whole run's imports, the program's included, in a fresh
    process: no top-level ``jax``, ``jaxlib``, ``flax`` or ``odtpu``."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from test_benchmark_harness import run\n"
        "run('ssd300_vgg16_voc.serve_b32', 0.1)\n"
        "from benchmark.run import banned_modules\n"
        "print(banned_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name,gflops", [("ssd300_vgg16_voc", 62.747076),
                                         ("rfbnet512_vgg16_voc", 206.830324)])
def test_forward_flops(name, gflops):
    assert yardstick.forward_flops(cells.config(name)) / 1e9 == \
        pytest.approx(gflops, abs=1e-6)


def test_norm_inputs():
    shapes = yardstick.norm_inputs(cells.config("rfbnet512_vgg16_voc"), 32)
    assert len(shapes) == 71
    assert max(shapes, key=lambda s: s[1] * s[2] * s[3]) == (32, 512, 64, 64)
    assert yardstick.norm_inputs(cells.config("ssd300_vgg16_voc"), 32) == []


def test_trace_reading(tmp_path):
    import json
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 16,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 50}]}))
    t = yardstick.read_trace(str(path))
    assert t["busy_us"] == 25 and t["window_us"] == 50
    b = yardstick.breakdown(t)
    assert b["device_ops"][0] == ["a", 20e-6]
    assert b["idle_gaps"] == [["aten::x", 15e-6]]
    assert yardstick.kernel_seconds(t, "a") == (20e-6, 2)

