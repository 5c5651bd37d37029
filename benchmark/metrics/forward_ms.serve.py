"""Device ms of ``EvalStep.forward`` a batch (the model), CUDA events
averaged over the traced window."""


def read(ctx):
    return ctx["spans_ms"].get("forward")
