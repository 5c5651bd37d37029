"""Device ms of ``TrainStep.backward`` an update, CUDA events averaged over
the traced window."""


def read(ctx):
    return ctx["spans_ms"].get("backward")
