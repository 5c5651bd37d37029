"""One tracer for the port: spans at its layers' boundaries.

``with trace.span("detect.topk"):`` marks a stage. While the tracer is
enabled (:func:`enable`) a span records its host time
(``perf_counter_ns``), its device time (a pair of CUDA events on the
current stream, read by :func:`summary`), the span it runs inside and
the step it belongs to: a span opened with ``step=True``
(``serve.step``, ``train.step``) starts the next step, and every span
until the next such one shares its id. Off, the default, a span records
nothing, creates no CUDA event and never synchronises: it costs a check
of this module's flag and of the profiler's, and returns a shared no-op
context.

Whenever a ``torch.profiler`` is active a span also opens
``record_function("odtpu.<name>")``, with the tracer on or off, so that
a Chrome trace holds the program's stages as host events on the
kernels' clock: an idle gap of the device while the host is inside a
stage, between two aten operations, is put down to that stage.

:func:`summary` gives, by span name, the calls, the steps they ran in,
the host and device ms a call, the self time a call (the span less
what its child spans cover) and the names of the spans it ran inside.
:func:`reset` forgets what was recorded; call it between steps, with no
span open. The closed spans' events are kept until :func:`summary`, so
enable the tracer for a stretch of steps, not for a whole run.

The spans and what reads them are listed in PERF.md (section 3). The
tracer follows one thread: spans opened from two threads at once while
it is enabled would nest into each other.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.autograd import profiler as _profiler

_on = False  # the one check an off span makes (with the profiler's)
_OFF = contextlib.nullcontext()


class _Stat:
    """What the closed spans of one name add up to."""

    __slots__ = ("calls", "timed", "steps", "last_step", "host_ns",
                 "self_host_ns", "device_ms", "self_device_ms", "parents")

    def __init__(self):
        self.calls = self.timed = self.steps = 0
        self.last_step = None
        self.host_ns = self.self_host_ns = 0
        self.device_ms = self.self_device_ms = 0.0
        self.parents = set()


class Tracer:
    """The spans of one process (:data:`TRACER`)."""

    def __init__(self):
        self.cuda = False  # whether spans time the device
        self.step = 0
        self.stack: list[_Span] = []  # open spans, innermost last
        self.closed: list[_Span] = []  # in the order they closed

    def summary(self) -> dict:
        if any(s.events is not None for s in self.closed):
            torch.cuda.synchronize()
        stats: dict[str, _Stat] = {}
        child_ms: dict[int, float] = {}  # id(span) -> its children's ms
        for s in self.closed:  # a child closes before its parent
            ms = (s.events[0].elapsed_time(s.events[1])
                  if s.events is not None else None)
            st = stats.get(s.name)
            if st is None:
                st = stats[s.name] = _Stat()
            st.calls += 1
            if s.step != st.last_step:
                st.steps += 1
                st.last_step = s.step
            st.host_ns += s.host_ns
            st.self_host_ns += s.host_ns - s.child_ns
            if ms is not None:
                st.timed += 1
                st.device_ms += ms
                st.self_device_ms += ms - child_ms.pop(id(s), 0.0)
                if s.parent is not None:
                    key = id(s.parent)
                    child_ms[key] = child_ms.get(key, 0.0) + ms
            if s.parent is not None:
                st.parents.add(s.parent.name)
        spans = {}
        for name, st in stats.items():
            n = st.timed
            spans[name] = {
                "calls": st.calls, "steps": st.steps,
                "host_ms": st.host_ns / 1e6 / st.calls,
                "self_host_ms": st.self_host_ns / 1e6 / st.calls,
                "device_ms": st.device_ms / n if n else None,
                "self_device_ms": st.self_device_ms / n if n else None,
                "parents": sorted(st.parents)}
        return {"spans": spans}


TRACER = Tracer()


class _Span:
    """One span: recorded into :data:`TRACER` when ``record``, else only
    labelled for a profiler."""

    __slots__ = ("name", "is_step", "record", "parent", "step", "t0",
                 "host_ns", "child_ns", "events", "label")

    def __init__(self, name: str, is_step: bool, record: bool):
        self.name, self.is_step, self.record = name, is_step, record
        self.parent = self.events = self.label = None
        self.step = self.host_ns = self.child_ns = 0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.label = torch.profiler.record_function("odtpu." + self.name)
            self.label.__enter__()
        if self.record:
            tr = TRACER
            self.parent = tr.stack[-1] if tr.stack else None
            if self.is_step:
                tr.step += 1
            self.step = tr.step
            tr.stack.append(self)
            if tr.cuda:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.record:
            tr = TRACER
            self.host_ns = time.perf_counter_ns() - self.t0
            if self.events is not None:
                self.events[1].record()
            tr.stack.pop()
            if self.parent is not None:
                self.parent.child_ns += self.host_ns
            tr.closed.append(self)
        if self.label is not None:
            self.label.__exit__(*exc)
        return False


def span(name: str, step: bool = False):
    """A context manager around one stage (see the module's docstring);
    ``step`` starts a new step."""
    if _on or _profiler._is_profiler_enabled:
        return _Span(name, step, _on)
    return _OFF


def spanned(name: str, step: bool = False):
    """A decorator: the whole function is the span ``name`` (as
    :func:`span`)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name, step):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def enable(cuda: bool | None = None) -> None:
    """Record spans from now on; ``cuda`` (default: whether CUDA is
    available) times each span on the device too."""
    global _on
    TRACER.cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`summary`."""
    global _on
    _on = False


def reset() -> None:
    """Forget every span recorded so far."""
    TRACER.closed = []


def summary() -> dict:
    """``{"spans": {name: {"calls", "steps", "host_ms", "self_host_ms",
    "device_ms", "self_device_ms", "parents"}}}``: times in ms a call,
    device times None where the tracer does not time the card. Waits for
    the card when spans timed it."""
    return TRACER.summary()
