"""The device's idle share of the timed window, in %: one less the device's
busy time an iteration (an update), from the profiled stretch's trace of
the device's activity (kernels, copies and fills; overlaps counted
once), over the window's host-clock time an iteration. The profiler
slows the host that launches the work, so the stretch's own idle share
(``busy_s`` against ``window_s``) reads higher than the window's."""


def read(ctx):
    t = ctx["trace"]
    if not t["busy_us"]:
        return None
    busy = t["busy_us"] / 1e6 / t["iterations"]
    return 100.0 * (1.0 - busy / ctx["iteration_s"])
