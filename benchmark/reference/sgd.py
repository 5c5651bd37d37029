"""SGD with momentum and weight decay added to the gradient, plain:
``d = g + wd * p``, ``buf = d`` at the first step and ``momentum * buf +
d`` after, ``p = p - lr * buf``."""

from __future__ import annotations

import torch


@torch.no_grad()
def step(params: dict, grads: dict, bufs: dict, lr: float, momentum: float,
         weight_decay: float) -> None:
    for name, p in params.items():
        d = grads[name] + weight_decay * p
        buf = bufs.get(name)
        bufs[name] = d.clone() if buf is None else buf.mul_(momentum).add_(d)
        p.sub_(lr * bufs[name])
