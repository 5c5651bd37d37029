"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (each read by
``benchmark/metrics/<metric>.py``) with the device's busy time and a
breakdown. Every run checks the outputs of the timed path against the
plain reference (``benchmark/compare.py``) and prints each number beside
its limit, on standard error and under the result's last key. Exits
non-zero, printing no result, without the cards, or when ``jax``,
``jaxlib``, ``flax`` or ``odtpu`` is loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .cells import HERE, ROOT, load  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "odtpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is a banned one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def reader(metric: str):
    path = HERE / "metrics" / (metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed paths inside the checkout
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    import torch

    cell = load(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print("benchmark: the cell {} needs {} CUDA card(s); found {}".format(
            args.workload, cell["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    driver = importlib.import_module(
        "benchmark." + cell["traffic"]["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)

    found = banned_modules()
    if found:
        print("benchmark: loaded after the window: {}".format(
            ", ".join(found)), file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = reader(m["name"])(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    from .compare import verdict
    limits = cell["config"]["limits"][cell["traffic"]["driver"]]
    ok, checks = verdict(out["numbers"], limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power": power_limit()}
    result = {"correct": ok and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        t = out["trace"]
        from .yardstick import breakdown
        device["busy_s"] = t["busy_us"] / 1e6
        device["window_s"] = t["window_us"] / 1e6
        result["breakdown"] = breakdown(t)
    result["checks"] = checks
    print("timings " + " ".join("{} {:.3f}".format(k, v) for k, v in
                                out["timings"].items()), file=sys.stderr)
    for name, c in checks.items():
        print("check {} {!r} limit {!r}".format(name, c["value"],
                                                c["limit"]), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
