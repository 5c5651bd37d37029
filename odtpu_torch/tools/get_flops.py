"""FLOPs of a configuration's forward: ``python -m
odtpu_torch.tools.get_flops [--cfg_name NAME | --cfg YML]``.

Counterpart of root ``get_flops.py``. :func:`conv_breakdown` itemises
each conv as the reference's forward-hook counter does
(flops_benchmark.py:162-193: ``2 * kh * kw * Cin * Cout * Hout * Wout``,
plus ``Cout * Hout * Wout`` for a conv with a bias, halved into MACs at
get_flops.py:16): 31.386288 G for SSD300-VGG16 (get_flops.py:70).
:func:`model_cost` counts the whole forward with
``torch.utils.flop_counter.FlopCounterMode``: 2 FLOPs a multiply-add of
the convs and matrix products, no bias, norm or elementwise op (``odtpu``
prints XLA's cost analysis there, which adds the elementwise ops). Both
run on the ``meta`` device: shapes only, no weights, no compute, and the
counts do not depend on the compute dtype.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import create_model
from ..models.common import Conv
from ..utils.config import resolve_cfg_args


def _meta_model(cfg):
    with torch.device("meta"):
        model, _ = create_model(cfg)
    return model.eval()


def _input(cfg):
    h, w = cfg.MODEL.IMAGE_SIZE
    return torch.empty(1, h, w, 3, device="meta")


def conv_shapes(cfg) -> list[tuple]:
    """Every conv of one image's forward, in the order they run:
    (``odtpu``'s module path, (kh, kw, Cin, Cout), (Hout, Wout), has a
    bias)."""
    model = _meta_model(cfg)
    rows = []

    def record(name):
        def hook(module, inputs, output):
            cout, cin, kh, kw = module.conv.weight.shape
            rows.append((name.replace(".", "/") + "/conv",
                         (kh, kw, cin, cout), tuple(output.shape[2:]),
                         module.conv.bias is not None))
        return hook

    # every conv of the zoo is a models.common.Conv (its weight under
    # ``conv``), which calls the conv functionally: the hook is on it
    hooks = [m.register_forward_hook(record(name))
             for name, m in model.named_modules() if isinstance(m, Conv)]
    try:
        model(_input(cfg), phase="train")
    finally:
        for h in hooks:
            h.remove()
    return rows


def conv_breakdown(cfg):
    """Per-conv MACs by the reference's hook formula; returns (rows,
    total GMACs), rows (path, kernel shape, out hw, GMACs)."""
    rows, total = [], 0.0
    for path, (kh, kw, cin, cout), (oh, ow), bias in conv_shapes(cfg):
        flops = 2.0 * kh * kw * cin * cout * oh * ow
        if bias:
            flops += cout * oh * ow
        total += flops
        rows.append((path, (kh, kw, cin, cout), (oh, ow), flops / 2e9))
    return rows, total / 2e9


def model_cost(cfg) -> float:
    """FLOPs of one image's forward by ``FlopCounterMode``."""
    model = _meta_model(cfg)
    with FlopCounterMode(display=False) as counter:
        model(_input(cfg), phase="train")
    return float(counter.get_total_flops())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="conv MACs and forward FLOPs")
    p.add_argument("--cfg", default="")
    p.add_argument("--cfg_name", default="")
    p.add_argument("--job_group", default="")
    cfg = resolve_cfg_args(p.parse_args(argv))

    rows, conv_gmacs = conv_breakdown(cfg)
    print("per-conv MACs (reference hook formula, "
          "flops_benchmark.py:162-193):")
    for name, k, hw, g in rows:
        print("  {:40s} k={} out={}  {:.4f} G".format(name, k, hw, g))
    print("conv GMACs total: {:.6f}".format(conv_gmacs),
          "(== reference get_flops.py expected 31.386288 for the "
          "default SSD300-VGG16)")
    flops = model_cost(cfg)
    print("FlopCounterMode flops: {:.6f} G".format(flops / 1e9))
    print("FlopCounterMode as GMACs: {:.6f}".format(flops / 2e9))
    print("  (FlopCounterMode counts 2 FLOPs a multiply-add of the convs "
          "and matrix products, without their biases; odtpu prints XLA's "
          "cost analysis, which adds the elementwise ops)")
    return {"rows": rows, "conv_gmacs": conv_gmacs, "flops": flops}


if __name__ == "__main__":
    main()
