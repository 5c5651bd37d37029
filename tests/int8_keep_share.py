"""How many of a configuration's float32 rows its int8 rows keep, in
``odtpu`` (its ``make_eval_step`` under ``TPU.QUANT = "int8"``, jitted as
it serves) and in the port (``odtpu_torch.eval_step``), on the same
seeded weights and images as ``chip_smoke.py``'s int8 phase
(``infer.random_state_dict(cfg, 0)``, ``infer.random_images(B, size,
0)``), on the CPU. A share the two packages give alike is the
reference's behaviour on those weights, not a fault of the port.

    JAX_PLATFORMS=cpu python tests/int8_keep_share.py fpn_vgg16_voc \\
        ssd_vgg16_voc [--batch 2]

prints one JSON line per configuration. The rule is ``chip_smoke``'s
``kept_share``: a row is kept when a row of the other set of the same
class overlaps it by IoU >= 0.5.
"""

import argparse
import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_family_parity as fp  # noqa: E402
from chip_smoke import kept_share  # noqa: E402
from odtpu.models import model_factory as jmodel_factory  # noqa: E402
from odtpu.parallel import make_eval_step as jmake_eval_step  # noqa: E402
from odtpu_torch.eval_step import make_eval_step  # noqa: E402
from odtpu_torch.infer import random_images, random_state_dict  # noqa: E402
from odtpu_torch.models import model_factory  # noqa: E402
from odtpu_torch.utils.checkpoint import load_strict  # noqa: E402
from odtpu_torch.utils.config import load_cfg  # noqa: E402


def keep_shares(name, batch):
    t0 = time.perf_counter()
    cfg, jcfg = load_cfg(name), fp.jax_cfg(name)
    for c in (cfg, jcfg):
        c.TPU.COMPUTE_DTYPE = "float32"
    weights = random_state_dict(cfg, seed=0)
    variables = fp.odtpu_variables(weights)
    images = random_images(batch, cfg.MODEL.IMAGE_SIZE, 0)
    jmodel, jpriors, _ = jmodel_factory("eval", jcfg)
    model, priors, _ = model_factory("eval", cfg, "cpu")
    load_strict(model, weights)
    model.eval()
    rows = {}
    for mode in ("", "int8"):
        jcfg.TPU.QUANT = cfg.TPU.QUANT = mode
        jstep = jmake_eval_step(jmodel, jpriors, jcfg, compact=True)
        out = jax.jit(jstep.raw_step)(
            variables["params"], variables.get("batch_stats", {}),
            jstep.priors, jnp.asarray(images))
        rows["odtpu", mode] = torch.from_numpy(np.array(out["rows"]))
        rows["port", mode] = make_eval_step(model, priors, cfg)(
            torch.from_numpy(images))["rows"]
    return {"cfg": name, "batch": batch,
            "odtpu_f32_rows_kept_by_int8": kept_share(
                rows["odtpu", ""], rows["odtpu", "int8"]),
            "port_f32_rows_kept_by_int8": kept_share(
                rows["port", ""], rows["port", "int8"]),
            "odtpu_f32_rows_kept_by_port": kept_share(
                rows["odtpu", ""], rows["port", ""]),
            "odtpu_int8_rows_kept_by_port": kept_share(
                rows["odtpu", "int8"], rows["port", "int8"]),
            "rows": {"{}_{}".format(p, m or "f32"): int((r[..., 0] > 0).sum())
                     for (p, m), r in rows.items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cfgs", nargs="+")
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for name in args.cfgs:
        print(json.dumps(keep_shares(name, args.batch)), flush=True)


if __name__ == "__main__":
    main()
