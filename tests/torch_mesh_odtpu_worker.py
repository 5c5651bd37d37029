"""``odtpu``'s side of tests/test_torch_mesh.py (not a test file; it
imports JAX and ``odtpu``):

    python tests/torch_mesh_odtpu_worker.py WORK DxMxS

on a JAX CPU mesh of that shape (``odtpu``'s ``make_mesh``), its
tensor-parallel threshold lowered to the worker's 64 channels, from the
port's float64 weights and batch in ``WORK/fssd.pt`` and ``WORK/ssd.pt``:

- ``odtpu``'s float64 FSSD ``make_train_step``, the state placed by
  ``param_shardings``: the metrics, and the momenta and batch statistics
  after it as the port's state-dict keys;
- ``odtpu``'s float64 SSD ``make_eval_step``: the rows;
- at 1x1x2, the FSSD step again under ``TPU.REMAT`` (``jax.checkpoint``);
- at 1x2x1, SSD's and FSSD's jitted float32 int8 eval steps
  (``TPU.QUANT``) on the mesh and unsharded: both rows.

Writes ``WORK/odtpu_<DxMxS>.pt``. Its photometric draws are ``odtpu``'s
own (key 17, step 0), which the test gave the port's ranks as well.
"""

import os
import sys

import conftest  # noqa: F401  JAX on the CPU, 8 devices

import jax
import jax.numpy as jnp
import numpy as np
import torch

import odtpu.data.device_aug  # noqa: F401  imported before any trace
from odtpu.parallel import mesh as jmesh
from odtpu.parallel import train as jtrain
from odtpu.utils.config import default_cfg as jdefault_cfg
from odtpu_torch.utils.checkpoint import from_odtpu_params

import torch_family_parity as fp
import torch_mesh_worker as mw
import torch_parallel_worker as pw
from test_torch_train_families import _jax_model, tiny_cfg


def jax_mesh(case, layout, dtype="float64", **tpu):
    """odtpu's (model, priors, cfg, mesh) of ``case`` on a CPU mesh of
    ``layout``, in ``dtype``, the ``tpu`` keys set in ``TPU``."""
    jcfg = tiny_cfg(jdefault_cfg(), *pw.CASES[case])
    jcfg.TPU.COMPUTE_DTYPE = dtype
    jcfg.TPU.update(tpu)
    jcfg.DATASET.DEVICE_PHOTOMETRIC = True
    jcfg.TPU.MESH_DATA, jcfg.TPU.MESH_MODEL, jcfg.TPU.MESH_SPATIAL = layout
    jmodel, jpriors = _jax_model(jcfg)
    mesh = jmesh.make_mesh(jcfg, devices=jax.devices()[:int(np.prod(
        layout))])
    return jmodel, jpriors, jcfg, mesh


def odtpu_step(data, layout, remat=False):
    """odtpu's FSSD step from ``data``'s weights: (metrics, momenta,
    batch statistics), the last two as the port's flat maps."""
    jmodel, jpriors, jcfg, mesh = jax_mesh("fssd", layout, REMAT=remat)
    v = fp.odtpu_variables(data["weights"])
    tx, _ = jtrain.make_optimizer(jcfg)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                              params=v["params"],
                              opt_state=tx.init(v["params"]),
                              batch_stats=v["batch_stats"])
    state = jax.tree.map(jax.device_put, state,
                         jmesh.param_shardings(state, mesh))
    step = jtrain.make_train_step(jmodel, jpriors, jcfg, tx, mesh=mesh,
                                  donate=False)
    batch = jmesh.shard_batch((data["images"].numpy(),
                               data["boxes"].numpy(),
                               data["labels"].numpy()), mesh)
    new, metrics = jax.device_get(step(state, *batch))
    tensors = lambda flat: {k: torch.from_numpy(np.asarray(v))  # noqa: E731
                            for k, v in from_odtpu_params(flat).items()}
    return ({k: float(v) for k, v in metrics.items()},
            tensors(fp._momentum(new.opt_state)),
            tensors(fp.flat_variables({"batch_stats": new.batch_stats})))


def odtpu_rows(data, layout):
    """odtpu's SSD eval rows from ``data``'s weights."""
    jmodel, jpriors, jcfg, mesh = jax_mesh("ssd", layout)
    v = fp.odtpu_variables(data["weights"])
    step = jtrain.make_eval_step(jmodel, jpriors, jcfg, mesh=mesh,
                                 compact=True)
    return np.asarray(step(v["params"], {},
                           jnp.asarray(data["images"].numpy()))["rows"])


def odtpu_int8_rows(data, case, layout):
    """odtpu's jitted float32 int8 rows of ``case`` from ``data``'s
    weights, on the mesh of ``layout`` and unsharded."""
    jmodel, jpriors, jcfg, mesh = jax_mesh(case, layout, "float32",
                                           QUANT="int8")
    v = fp.odtpu_variables({k: v.float() if v.is_floating_point() else v
                            for k, v in data["weights"].items()})
    images = jnp.asarray(data["images"].numpy())
    out = {}
    for key, on in (("mesh", mesh), ("one", None)):
        step = jtrain.make_eval_step(jmodel, jpriors, jcfg, mesh=on,
                                     compact=True)
        out[key] = torch.from_numpy(np.array(step(
            v["params"], v.get("batch_stats", {}), images)["rows"]))
    return out


def main(work, text):
    layout = mw.layout_of(text)
    jmesh._TP_MIN_CHANNELS = mw.TP_MIN_CHANNELS
    load = lambda case: torch.load(  # noqa: E731
        os.path.join(work, case + ".pt"), weights_only=True)
    with fp.odtpu_float64():
        metrics, momentum, stats = odtpu_step(load("fssd"), layout)
        rows = odtpu_rows(load("ssd"), layout)
        out = {"metrics": metrics, "momentum": momentum, "stats": stats,
               "rows": torch.from_numpy(rows)}
        if layout == (1, 1, 2):
            out["remat"] = dict(zip(("metrics", "momentum", "stats"),
                                    odtpu_step(load("fssd"), layout,
                                               remat=True)))
    if layout == (1, 2, 1):
        out["int8"] = {case: odtpu_int8_rows(load(case), case, layout)
                       for case in ("ssd", "fssd")}
    torch.save(out, os.path.join(work, "odtpu_{}.pt".format(text)))
    print("odtpu done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
