"""Device ms of ``TrainStep.augment`` an update, CUDA events averaged over
the traced window."""


def read(ctx):
    return ctx["spans_ms"].get("augment")
