"""Cells by name: ``BENCHMARK.json``'s entry, its configuration file
(``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<traffic>.json``), plus the program's own config
tree for the configuration, checked against the configuration file."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def spec() -> dict:
    with open(SPEC) as f:
        return json.load(f)


def config(name: str) -> dict:
    with open(HERE / "configs" / (name + ".json")) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / (name + ".json")) as f:
        return json.load(f)


def load(workload: str) -> dict:
    """{"name", "config", "traffic", "chips", "end_to_end", "per_layer"}:
    the cell, its two files read, and the metrics ``BENCHMARK.json``
    gives it (an end-to-end metric with a ``workloads`` list only in the
    cells it names; a per-layer metric where its ``workloads`` list names
    the cell)."""
    s = spec()
    cells = {w["name"]: w for w in s["workloads"]}
    if workload not in cells:
        raise KeyError("no cell {!r}; the cells are {}".format(
            workload, sorted(cells)))
    cell = cells[workload]
    e2e = [m for m in s["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = [m for m in s["per_layer"] if workload in m["workloads"]]
    return {"name": workload, "config": config(cell["config"]),
            "traffic": traffic(cell["traffic"]), "chips": cell["chips"],
            "end_to_end": e2e, "per_layer": per_layer}


def _dotted(tree, key: str):
    node = tree
    for part in key.split("."):
        node = node[part]
    return node


def _set_dotted(tree, key: str, value) -> None:
    *head, last = key.split(".")
    node = tree
    for part in head:
        node = node[part]
    if last not in node:
        raise KeyError("the program's config has no {}".format(key))
    node[last] = value


# configuration-file key -> the program's config key it must equal
PORT_KEYS = {
    "num_classes": "MODEL.NUM_CLASSES", "image_size": "MODEL.IMAGE_SIZE",
    "steps": "MODEL.STEPS", "min_sizes": "MODEL.MIN_SIZES",
    "max_sizes": "MODEL.MAX_SIZES", "aspect_ratios": "MODEL.ASPECT_RATIOS",
    "variance": "MODEL.VARIANCE", "clip": "MODEL.CLIP",
    "flip": "MODEL.FLIP", "top_k": "EVAL.TOP_K",
    "conf_thresh": "EVAL.CONF_THRESH", "nms_thresh": "EVAL.NMS_THRESH",
    "compute_dtype": "TPU.COMPUTE_DTYPE",
    "pixel_means": "DATASET.PIXEL_MEANS",
    "overlap_thresh": "LOSS.OVERLAP_THRESH",
    "neg_pos_ratio": "LOSS.NEG_POS_RATIO", "loc_weight": "LOSS.LOC_WEIGHT",
}


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def port_cfg(cfg: dict):
    """The program's config tree of ``cfg["port_cfg"]`` with
    ``port_cfg_changes`` laid over it, after checking that it states what
    the configuration file states (the reference reads the file)."""
    from odtpu_torch.utils.config import load_cfg
    tree = load_cfg(cfg["port_cfg"])
    for key, value in cfg["port_cfg_changes"].items():
        _set_dotted(tree, key, value)
    wrong = {k: (cfg[k], _dotted(tree, v)) for k, v in PORT_KEYS.items()
             if not _same(cfg[k], _dotted(tree, v))}
    opt = tree.TRAIN.OPTIMIZER
    for k, v in (("name", str(opt.OPTIMIZER).lower()), ("lr", opt.LR),
                 ("momentum", opt.MOMENTUM),
                 ("weight_decay", opt.WEIGHT_DECAY)):
        if not _same(cfg["optimizer"][k], v):
            wrong["optimizer." + k] = (cfg["optimizer"][k], v)
    if float(opt.CLIP_GRAD_NORM or 0) or int(
            tree.TRAIN.LR_SCHEDULER.WARMUP_ITERS):
        wrong["clip or warmup"] = ("off", "on")
    if wrong:
        raise ValueError("{}'s config differs from {}.json (file, program): "
                         "{}".format(cfg["port_cfg"], cfg["name"], wrong))
    return tree
