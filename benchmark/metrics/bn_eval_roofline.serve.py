"""The eval-mode norm kernel's share of its roofline: the least time of
a batch's norms (``yardstick.bn_eval_least_ms`` of each norm input of
the reference model), a launch on average, over the kernel's device
time a launch in the profiled stretch, in %."""

from benchmark import yardstick


def read(ctx):
    least = ctx.get("bn_eval_least_ms")
    if not least:
        return None
    seconds, launches = yardstick.kernel_seconds(ctx["trace"], "bn_eval")
    if not launches:
        return None
    per_launch = sum(least) / len(least)
    return 100.0 * per_launch * launches / (1e3 * seconds)
