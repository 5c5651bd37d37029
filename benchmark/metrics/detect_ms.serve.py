"""Device ms of ``EvalStep.detect`` a batch (decode, per-class top-k,
NMS, the cross-class rows and ``dropped``), CUDA events averaged over the
traced window."""


def read(ctx):
    return ctx["spans_ms"].get("detect")
