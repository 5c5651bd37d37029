"""Observability: a timer and a TensorBoard writer.

Counterpart of ``odtpu/utils/logging.py``: ``Timer`` (the reference's
lib/utils/utils.py:12), whose ``diff`` the train loop logs as
``train/time``, and ``TBWriter`` (lib/utils/visualize_utils.py:8):
scalars, HWC images, histograms and per-class PR curves. Where
``torch.utils.tensorboard`` cannot be imported (it needs the
``tensorboard`` package), the writer prints one line and writes nothing.
"""

from __future__ import annotations

import time

import numpy as np

from .. import parallel


class Timer:
    """tic/toc accumulator (reference utils.py:12-34)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average=True):
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


class TBWriter:
    """TensorBoard event files under ``log_dir`` (none when ``log_dir`` is
    empty or TensorBoard is missing, and none on a rank other than 0 of a
    process group). ``writer`` is the ``SummaryWriter`` or None; a caller
    may put any object with its methods there."""

    def __init__(self, log_dir):
        self.writer = None
        if log_dir and parallel.is_main():
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print("tensorboard unavailable:", e)
            else:
                self.writer = SummaryWriter(log_dir)

    def add_scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def add_scalars(self, prefix, scalars, step):
        for k, v in scalars.items():
            self.add_scalar("{}/{}".format(prefix, k), v, step)

    def add_image(self, tag, img_hwc, step):
        if self.writer is not None:
            self.writer.add_image(tag, img_hwc, int(step), dataformats="HWC")

    def add_histogram(self, tag, values, step):
        if self.writer is not None:
            self.writer.add_histogram(tag, values, int(step))

    def add_pr_curves(self, res, step=0):
        """res: [(cls, ap, prec, rec)] from the VOC evaluator; one raw PR
        curve a class that has detections."""
        if self.writer is None:
            return
        for cls, ap, prec, rec in res:
            if not hasattr(prec, "__len__"):
                continue
            n = len(prec)
            if n == 0:
                continue
            self.writer.add_pr_curve_raw(
                "pr/{}".format(cls),
                true_positive_counts=np.zeros(n),
                false_positive_counts=np.zeros(n),
                true_negative_counts=np.zeros(n),
                false_negative_counts=np.zeros(n),
                precision=np.asarray(prec),
                recall=np.asarray(rec),
                global_step=step, num_thresholds=n)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
