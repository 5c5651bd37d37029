"""A TensorBoard writer of scalars.

Counterpart of ``odtpu/utils/logging.py``'s TBWriter (the reference's
lib/utils/visualize_utils.py:8); its Timer has no caller in the port.
The writer takes scalars only: the images and PR curves of ``odtpu``'s
need ``utils/visualize.py``, which is not ported. Where
``torch.utils.tensorboard`` cannot be imported (it needs the
``tensorboard`` package), the writer prints one line and writes nothing.
"""

from __future__ import annotations

from .. import parallel


class TBWriter:
    """Scalars to TensorBoard event files under ``log_dir`` (none when
    ``log_dir`` is empty or TensorBoard is missing, and none on a rank
    other than 0 of a process group)."""

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

    def close(self):
        if self.writer is not None:
            self.writer.close()
