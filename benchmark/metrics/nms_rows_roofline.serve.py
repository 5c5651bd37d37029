"""The NMS kernel's share of its roofline: the least time of its work
(``yardstick.nms_rows_least_ms`` on the reference's candidate sets of
the compared batches) over its device time a launch in the profiled
stretch, in %."""

from benchmark import yardstick


def read(ctx):
    if not ctx.get("nms_rows_least_ms"):
        return None
    seconds, launches = yardstick.kernel_seconds(ctx["trace"],
                                                 "nms_rows_kernel")
    if not launches:
        return None
    return 100.0 * ctx["nms_rows_least_ms"] * launches / (1e3 * seconds)
