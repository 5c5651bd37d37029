"""The 95th percentile of a batch's wait in the traced window, in ms:
from the host call that submits the batch to its rows and ``dropped``
on the host, over every batch of the window (``serve.p95``). In a
closed loop the wait follows the batches in flight, so it moves with
the throughput and swings with the host's speed: a per-layer metric."""


def read(ctx):
    return ctx["batch_p95_ms"]
