"""``odtpu``'s side of tests/test_torch_mesh.py (not a test file; it
imports JAX and ``odtpu``):

    python tests/torch_mesh_odtpu_worker.py WORK DxMxS

on a JAX CPU mesh of that shape (``odtpu``'s ``make_mesh``), its
tensor-parallel threshold lowered to the worker's 64 channels, from the
port's float64 weights and batch in ``WORK/fssd.pt`` and ``WORK/ssd.pt``:

- ``odtpu``'s float64 FSSD ``make_train_step``, the state placed by
  ``param_shardings``: the metrics, and the momenta and batch statistics
  after it as the port's state-dict keys;
- ``odtpu``'s float64 SSD ``make_eval_step``: the rows.

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


def jax_mesh(case, layout):
    """odtpu's float64 (model, priors, cfg, mesh) of ``case`` on a CPU
    mesh of ``layout``."""
    jcfg = tiny_cfg(jdefault_cfg(), *pw.CASES[case])
    jcfg.TPU.COMPUTE_DTYPE = "float64"
    jcfg.DATASET.DEVICE_PHOTOMETRIC = True
    jcfg.TPU.MESH_DATA, jcfg.TPU.MESH_MODEL, jcfg.TPU.MESH_SPATIAL = layout
    jmodel, jpriors = _jax_model(jcfg)
    mesh = jmesh.make_mesh(jcfg, devices=jax.devices()[:int(np.prod(
        layout))])
    return jmodel, jpriors, jcfg, mesh


def odtpu_step(data, layout):
    """odtpu's FSSD step from ``data``'s weights: (metrics, momenta,
    batch statistics), the last two as the port's flat maps."""
    jmodel, jpriors, jcfg, mesh = jax_mesh("fssd", layout)
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


def main(work, text):
    layout = mw.layout_of(text)
    jmesh._TP_MIN_CHANNELS = mw.TP_MIN_CHANNELS
    load = lambda case: torch.load(  # noqa: E731
        os.path.join(work, case + ".pt"), weights_only=True)
    with fp.odtpu_float64():
        metrics, momentum, stats = odtpu_step(load("fssd"), layout)
        rows = odtpu_rows(load("ssd"), layout)
    torch.save({"metrics": metrics, "momentum": momentum, "stats": stats,
                "rows": torch.from_numpy(rows)},
               os.path.join(work, "odtpu_{}.pt".format(text)))
    print("odtpu done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
