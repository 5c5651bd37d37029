"""The port's tracer (``odtpu_torch.trace``): off it records
nothing, on it records nesting, steps, self time and device time; its
spans label a ``torch.profiler`` trace either way; the serving and train
steps open exactly the spans PERF.md lists; ``--profile_dir`` writes
their summary beside the trace."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from odtpu_torch import trace, train
from odtpu_torch.infer import Detector
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils.config import default_cfg

SERVE_SPANS = {"serve.step", "serve.forward", "serve.detect",
               "detect.decode", "detect.topk", "detect.nms",
               "detect.compact"}
TRAIN_SPANS = {"train.step", "train.augment", "train.forward",
               "train.targets_h2d", "train.loss", "train.backward",
               "train.update"}


@pytest.fixture(autouse=True)
def tracer(monkeypatch):
    """A fresh tracer, off, for each test."""
    monkeypatch.setattr(trace, "TRACER", trace.Tracer())
    monkeypatch.setattr(trace, "_on", False)
    return trace


class FakeEvent:
    """A CUDA event on a made-up device clock: each ``record`` reads
    ``CLOCK`` and adds 1 ms to it; it can be read only after
    ``synchronize``."""

    CLOCK = [0.0]
    DONE = [False]
    MADE = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        FakeEvent.MADE.append(self)

    def record(self, stream=None):
        self.at = FakeEvent.CLOCK[0]
        FakeEvent.CLOCK[0] += 1.0

    def elapsed_time(self, end):
        assert FakeEvent.DONE[0], "read before the card passed it"
        return end.at - self.at


@pytest.fixture()
def fake_cuda(monkeypatch):
    FakeEvent.CLOCK[0], FakeEvent.DONE[0] = 0.0, False
    FakeEvent.MADE.clear()
    syncs = []

    def synchronize(device=None):
        syncs.append(device)
        FakeEvent.DONE[0] = True

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return syncs


def _nest():
    """Two steps: each an ``s.step`` holding ``a`` and ``b``, ``b``
    holding ``c``; ``a`` and ``c`` sleep 2 ms."""
    for _ in range(2):
        with trace.span("s.step", step=True):
            with trace.span("a"):
                time.sleep(0.002)
            with trace.span("b"):
                with trace.span("c"):
                    time.sleep(0.002)


def test_off_records_nothing_and_makes_no_event(fake_cuda):
    @trace.spanned("f")
    def f(x):
        return x + 1

    assert not trace._on
    assert trace.span("a") is trace.span("b", step=True)  # shared no-op
    _nest()
    assert f(1) == 2
    assert trace.summary() == {"spans": {}}
    assert FakeEvent.MADE == [] and fake_cuda == []
    assert trace.TRACER.step == 0 and not trace.TRACER.closed


def test_on_records_nesting_steps_and_self_time():
    trace.enable(cuda=False)
    _nest()
    spans = trace.summary()["spans"]
    assert set(spans) == {"s.step", "a", "b", "c"}
    for name, parents in (("s.step", []), ("a", ["s.step"]),
                          ("b", ["s.step"]), ("c", ["b"])):
        assert spans[name]["calls"] == 2
        assert spans[name]["steps"] == 2
        assert spans[name]["parents"] == parents
        assert spans[name]["device_ms"] is None
        assert spans[name]["self_device_ms"] is None
    assert spans["a"]["host_ms"] >= 2.0 and spans["c"]["host_ms"] >= 2.0
    # self time: the span less what its children cover
    step = spans["s.step"]
    assert step["self_host_ms"] == pytest.approx(
        step["host_ms"] - spans["a"]["host_ms"] - spans["b"]["host_ms"])
    assert spans["b"]["self_host_ms"] == pytest.approx(
        spans["b"]["host_ms"] - spans["c"]["host_ms"])
    assert spans["c"]["self_host_ms"] == spans["c"]["host_ms"]
    assert step["host_ms"] >= 4.0 > step["self_host_ms"] >= 0.0


def test_step_id_is_shared_by_the_spans_of_one_step():
    trace.enable(cuda=False)
    with trace.span("x"):  # before any step: step 0
        pass
    for _ in range(3):
        with trace.span("t.step", step=True):
            for _ in range(2):
                with trace.span("x"):
                    pass
    spans = trace.summary()["spans"]
    assert (spans["x"]["calls"], spans["x"]["steps"]) == (7, 4)
    assert (spans["t.step"]["calls"], spans["t.step"]["steps"]) == (3, 3)
    assert spans["x"]["parents"] == ["t.step"]


def test_device_time_is_read_from_events_in_the_summary(fake_cuda):
    trace.enable(cuda=True)
    # on the fake clock each record adds 1 ms: s.step's events at 0 and
    # 5, a's at 1 and 2, b's at 3 and 4
    with trace.span("s.step", step=True):
        with trace.span("a"):
            pass
        with trace.span("b"):
            pass
    assert len(FakeEvent.MADE) == 6
    # nothing is read, and nothing waits, before summary()
    assert len(trace.TRACER.closed) == 3 and fake_cuda == []
    spans = trace.summary()["spans"]
    assert len(fake_cuda) == 1  # one synchronise, in summary()
    assert spans["s.step"]["device_ms"] == 5.0
    assert spans["s.step"]["self_device_ms"] == 3.0
    assert spans["a"]["device_ms"] == spans["b"]["device_ms"] == 1.0
    assert spans["a"]["self_device_ms"] == 1.0
    assert trace.summary()["spans"] == spans
    assert len(fake_cuda) == 2  # a second summary reads the same events


def test_device_self_time_is_per_call_of_the_parent(fake_cuda):
    trace.enable(cuda=True)
    # first step: p's events at 0 and 3, c's at 1 and 2 (p 3 ms, c 1 ms);
    # second step: p at 4 and 5, no child (p 1 ms)
    for child in (True, False):
        with trace.span("p", step=True):
            if child:
                with trace.span("c"):
                    pass
    spans = trace.summary()["spans"]
    assert spans["p"]["device_ms"] == 2.0
    assert spans["p"]["self_device_ms"] == 1.5  # (3 - 1 + 1) / 2
    assert (spans["c"]["calls"], spans["c"]["self_device_ms"]) == (1, 1.0)


def test_reset_forgets_what_was_recorded():
    trace.enable(cuda=False)
    with trace.span("serve.step", step=True):
        with trace.span("serve.forward"):
            pass
    trace.reset()
    with trace.span("serve.step", step=True):
        pass
    out = trace.summary()
    assert set(out["spans"]) == {"serve.step"}
    assert out["spans"]["serve.step"]["calls"] == 1


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_a_span_closes_when_its_body_raises(on):
    if on:
        trace.enable(cuda=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.span("s.step", step=True):
                with trace.span("a"):
                    raise ValueError
    assert trace.TRACER.stack == []
    spans = trace.summary()["spans"]
    assert set(spans) == ({"s.step", "a"} if on else set())


def test_enable_times_the_device_only_where_cuda_is(fake_cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace.enable()
    with trace.span("a", step=True):
        pass
    assert FakeEvent.MADE == [] and fake_cuda == []
    assert trace.summary()["spans"]["a"]["device_ms"] is None


def test_disable_keeps_what_was_recorded():
    trace.enable(cuda=False)
    with trace.span("a"):
        pass
    trace.disable()
    with trace.span("a"):
        pass
    assert trace.summary()["spans"]["a"]["calls"] == 1


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_spans_label_a_profiler_trace(on, tmp_path):
    if on:
        trace.enable(cuda=False)

    @trace.spanned("serve.step", step=True)
    def step():
        with trace.span("detect.topk"):
            return torch.ones(4).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    labels = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"odtpu.serve.step", "odtpu.detect.topk"} <= labels
    assert bool(trace.summary()["spans"]) == on
    # no profiler: no label, and off, no span object either
    assert (trace.span("x") is trace.span("y")) != on


def tiny_cfg():
    """SSD300's layout at 64x64 with four sources, float32."""
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DATASET.IMAGE_SIZE = (64, 64)
    cfg.MODEL.IMAGE_SIZE = (64, 64)
    cfg.MODEL.STEPS = [8, 16, 32, 64]
    cfg.MODEL.MIN_SIZES = [8, 16, 32, 48]
    cfg.MODEL.MAX_SIZES = [16, 32, 48, 64]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2], [2], [2]]
    cfg.MODEL.EXTRAS = [64, "S", 128, 64, "S", 128]
    return cfg


def test_serving_opens_the_serving_and_detect_spans():
    trace.enable(cuda=False)
    det = Detector(tiny_cfg(), device="cpu")
    assert trace.summary()["spans"] == {}  # set-up opens no span
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    for _ in range(3):
        out = det(images)
    assert out["rows"].shape[0] == 2
    spans = trace.summary()["spans"]
    assert set(spans) == SERVE_SPANS
    for name in SERVE_SPANS:
        assert (spans[name]["calls"], spans[name]["steps"]) == (3, 3), name
    assert spans["serve.step"]["parents"] == []
    for name in ("serve.forward", "serve.detect"):
        assert spans[name]["parents"] == ["serve.step"]
    for name in ("detect.decode", "detect.topk", "detect.nms",
                 "detect.compact"):
        assert spans[name]["parents"] == ["serve.detect"]


def test_serving_rows_are_the_same_with_the_tracer_on():
    det = Detector(tiny_cfg(), device="cpu")
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    off = det(images)
    trace.enable(cuda=False)
    on = det(images)
    torch.testing.assert_close(on["rows"], off["rows"], rtol=0, atol=0)
    torch.testing.assert_close(on["dropped"], off["dropped"], rtol=0,
                               atol=0)


def test_spanned_methods_keep_their_names_and_inference_mode():
    det = Detector(tiny_cfg(), device="cpu")
    step = det.step
    assert type(step).forward.__name__ == "forward"
    assert "images" in type(step).forward.__doc__
    trace.enable(cuda=False)
    images = torch.zeros(1, 64, 64, 3, dtype=torch.uint8)
    out = step.forward(images)
    assert all(t.is_inference() for t in out)
    assert step.detect(*out)["rows"].is_inference()


def test_training_opens_the_train_spans():
    trace.enable(cuda=False)
    cfg = tiny_cfg()
    state, priors = create_train_state(cfg, "cpu")
    step = make_train_step(priors, cfg)
    assert trace.summary()["spans"] == {}  # set-up opens no span
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7]], [[0.3, 0.2, 0.9, 0.8]]])
    labels = torch.tensor([[3], [11]])
    for _ in range(2):
        metrics = step(state, images, boxes, labels)
    assert torch.isfinite(metrics["loss"])
    spans = trace.summary()["spans"]
    assert set(spans) == TRAIN_SPANS
    for name in TRAIN_SPANS:
        assert (spans[name]["calls"], spans[name]["steps"]) == (2, 2), name
        want = [] if name == "train.step" else ["train.step"]
        assert spans[name]["parents"] == want, name


def test_profile_dir_writes_the_spans_of_the_profiled_steps(tmp_path):
    prof = train._Trace(str(tmp_path / "prof"), torch.device("cpu"))
    with trace.span("train.step", step=True):  # before: off, not kept
        pass
    prof.before_step(train.PROFILE_STEPS[0])
    assert trace._on
    for _ in range(2):
        with trace.span("train.step", step=True):
            torch.ones(8).sum()
    prof.stop()
    assert not trace._on
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["spans"]["train.step"]["calls"] == 2
    assert spans["spans"]["train.step"]["device_ms"] is None
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "odtpu.train.step"
               for e in events["traceEvents"])
