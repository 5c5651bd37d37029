"""Spans and the profiled stretch of a ``--trace 1`` run.

:class:`Spans` wraps a method of one object of the program (an
attribute set on the instance, so the class is untouched) with a pair
of CUDA events and a ``record_function`` label: its device time a call,
averaged over every call of the traced window.
:func:`profiled` runs a few more iterations under ``torch.profiler``
once the window has closed, reads its Chrome trace (written under
``build/benchmark/`` and deleted once read).
"""

from __future__ import annotations

import os
from collections import defaultdict

import torch

from . import yardstick
from .cells import ROOT

TRACE_DIR = ROOT / "build" / "benchmark"


class Spans:
    def __init__(self):
        self.events = defaultdict(list)

    def wrap(self, obj, method: str, label: str) -> None:
        fn = getattr(obj, method)
        events = self.events[label]

        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function("benchmark." + label):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            events.append((start, end))
            return out

        setattr(obj, method, wrapped)

    def reset(self) -> None:
        for v in self.events.values():
            v.clear()

    def mean_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / len(v)
                for k, v in self.events.items() if v}


def _profile(run_some, path, acts) -> dict:
    with torch.profiler.profile(activities=acts) as prof:
        iterations = run_some()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    try:
        out = yardstick.read_trace(str(path))
    finally:
        os.unlink(path)
    out["iterations"] = iterations
    return out


def profiled(run_some, workload: str) -> dict:
    """``run_some()`` (which returns the iterations it ran: batches or
    updates) twice under ``torch.profiler``, each ending in a
    synchronize: first with the device's activity alone (the kernels,
    the busy time and the window: recording the host's operations slows
    the host enough to starve the device), then with the host's
    operations too, whose trace says only what the host was doing in
    each idle gap. The device trace, with ``host_gaps`` from the second
    (see :func:`yardstick.read_trace`)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "{}.trace.json".format(workload)
    cuda = torch.profiler.ProfilerActivity.CUDA
    cpu = torch.profiler.ProfilerActivity.CPU
    device = _profile(run_some, path, [cuda])
    host = _profile(run_some, path, [cpu, cuda])
    device["host_gaps"] = (host["gaps"], host["host"])
    return device
