"""One rank of tests/test_torch_parallel.py's two-process runs (not a test
file; it imports no JAX).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py WORK

joins a gloo group on the CPU through ``parallel.init_distributed`` and,
reading what the test wrote under WORK (``job.json``; a VOC tree, a COCO
tree, each step case's weights and global batch), writes its results to
``WORK/rank<r>.pt`` (rank 1 the :func:`digest` of each tensor of its
step in place of the tensor, which keeps the file small):

- ``allgather_host_rows`` of ragged rows, 0 rows on a rank included;
- ``EvalVOC`` and ``EvalCOCO`` through ``dataset_factory("eval")`` (this
  rank's slice) with a perfect detector, whose ``dropped`` is 1 an
  image: mAP, the image count and ``dropped``, summed over the ranks;
- one train step of each case on this rank's rows of the global batch
  (the photometric parameters given for the global batch): the metrics,
  parameters, momenta and buffers after it, and the parameters the step
  drew itself for update 0.
"""

import datetime
import hashlib
import json
import os
import sys

import numpy as np
import torch

from odtpu_torch import parallel
from odtpu_torch.data import dataset_factory
from odtpu_torch.eval.evaluator import eval_solver_factory
from odtpu_torch.models import fssd
from odtpu_torch.train_step import create_train_state, make_train_step
from odtpu_torch.utils.config import default_cfg, load_cfg

torch.set_num_threads(2)

# tests/test_family_train.py's tiny FSSD pyramid: 8/4/2/1 from 64x64
TINY_PYRAMID = ((128, 1, 1), (128, 2, 1), (128, 2, 1), (128, 2, 1))


def tiny_cfg(cfg, ssd_type, base="vgg16", batch_norm=False):
    """tests/test_torch_train_families.py's 64x64 settings."""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.SSD_TYPE, cfg.MODEL.BASE = ssd_type, base
    cfg.MODEL.BATCH_NORM = batch_norm
    cfg.DATASET.IMAGE_SIZE = (64, 64)
    cfg.MODEL.IMAGE_SIZE = (64, 64)
    cfg.MODEL.STEPS = [8, 16, 32, 64]
    cfg.MODEL.MIN_SIZES = [8, 16, 32, 48]
    cfg.MODEL.MAX_SIZES = [16, 32, 48, 64]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2], [2], [2]]
    cfg.MODEL.EXTRAS = [64, "S", 128, 64, "S", 128]
    cfg.TRAIN.OPTIMIZER.LR = 1e-3
    cfg.TRAIN.OPTIMIZER.CLIP_GRAD_NORM = 5.0
    return cfg


# the step cases: (SSD_TYPE, BASE, BATCH_NORM)
CASES = {"ssd": ("SSD", "vgg16", False), "fssd": ("FSSD", "vgg16", False),
         "drnssd": ("DRN_SSD", "drn_d_22", False)}


def step_cfg(case):
    """The port's config of a step case: tiny, float64, the photometric
    distortion on the device."""
    cfg = tiny_cfg(default_cfg(), *CASES[case])
    cfg.TPU.COMPUTE_DTYPE = "float64"
    cfg.DATASET.DEVICE_PHOTOMETRIC = True
    return cfg


def one_step(case, weights, images, boxes, labels, draws):
    """(metrics, state, step) after one step of ``case`` from ``weights``
    on the batch, with the photometric parameters ``draws``."""
    fssd.FSSD300_PYRAMID = TINY_PYRAMID
    cfg = step_cfg(case)
    state, priors = create_train_state(cfg, "cpu")
    state.model.double()
    state.model.load_state_dict(weights)
    step = make_train_step(priors.double(), cfg)
    m = step(state, torch.as_tensor(images), torch.as_tensor(boxes),
             torch.as_tensor(labels), aug_params=draws)
    return m, state, step


def step_result(m, state):
    opt = state.optimizer.state
    return {"metrics": {k: v.double() for k, v in m.items()},
            "params": {k: p.detach().clone()
                       for k, p in state.model.named_parameters()},
            "momentum": {k: opt[p]["momentum_buffer"].clone()
                         for k, p in state.model.named_parameters()},
            "buffers": {k: b.clone()
                        for k, b in state.model.named_buffers()}}


def digest(t):
    """sha256 of a tensor's dtype, shape and bytes: equal digests, equal
    tensors bit for bit."""
    h = hashlib.sha256("{} {}".format(t.dtype, tuple(t.shape)).encode())
    h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def truth_step(dataset, batch, order):
    """A perfect detector for ``validate``: the batches of the images at
    ``order`` (this rank's slice), answered with their ground truth (score
    0.9, [0, 1] boxes, class + 1), and ``dropped`` 1 an image."""
    calls = [0]

    def step(images):
        rows = torch.zeros(images.shape[0], 200, 6)
        for k in range(images.shape[0]):
            i = calls[0] * batch + k
            if i < len(order):
                rec = dataset[order[i]]
                n = len(rec["labels"])
                rows[k, :n, 0] = 0.9
                rows[k, :n, 1:5] = torch.from_numpy(rec["boxes"])
                rows[k, :n, 5] = torch.from_numpy(rec["labels"] + 1.0)
        calls[0] += 1
        return {"rows": rows,
                "dropped": torch.ones(images.shape[0], dtype=torch.int32)}

    return step


def validate(name, root, sets, batch, out):
    cfg = load_cfg(name)
    cfg.DATASET.DATASET_DIR = root
    cfg.DATASET.TEST_SETS = sets
    cfg.DATASET.EVAL_BATCH_SIZE = batch
    cfg.DATASET.NUM_WORKERS = 1
    loader = dataset_factory("eval", cfg)
    solver = eval_solver_factory(loader, cfg, out)
    order = list(range(parallel.rank(), loader.num_items, parallel.world()))
    _, maps = solver.validate(truth_step(loader.dataset, batch, order))
    return {"maps": maps, "batches": len(loader), "slice": order,
            "images": solver.last_timing["images"],
            "dropped": solver.last_timing["dropped_dets"]}


def main(work):
    parallel.init_distributed("cpu", timeout=datetime.timedelta(seconds=120))
    r, w = parallel.rank(), parallel.world()
    with open(os.path.join(work, "job.json")) as f:
        job = json.load(f)
    out = {"rank": r, "world": w}

    k = 4
    rows = np.arange(3 * k, dtype=np.float32).reshape(3, k) + 100 * r
    out["gather_ragged"] = parallel.allgather_host_rows(rows[:3 - 3 * r])
    out["gather_uneven"] = parallel.allgather_host_rows(
        np.full((2 + 3 * r, k), r, np.float32))

    out["voc"] = validate("ssd_vgg16_voc", job["voc"], (("2007", "test"),),
                          2, os.path.join(work, "voc_out{}".format(r)))
    out["coco"] = validate("ssd_vgg16_coco", job["coco"], (("2014", "val"),),
                           2, os.path.join(work, "coco_out{}".format(r)))

    for case in job["cases"]:
        data = torch.load(os.path.join(work, case + ".pt"),
                          weights_only=True)
        b = data["images"].shape[0] // w
        rows = slice(r * b, (r + 1) * b)  # the global batch's r-th block
        m, state, step = one_step(
            case, data["weights"], data["images"][rows], data["boxes"][rows],
            data["labels"][rows],
            {k: v[rows] for k, v in data["draws"].items()})
        out[case] = step_result(m, state)
        if r:
            for k in ("params", "momentum", "buffers"):
                out[case][k] = {name: digest(v)
                                for name, v in out[case][k].items()}
        out[case]["own_draws"] = step.aug_params(b, 0)
    torch.save(out, os.path.join(work, "rank{}.pt".format(r)))
    parallel.barrier()
    parallel.shutdown()
    print("rank", r, "done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
