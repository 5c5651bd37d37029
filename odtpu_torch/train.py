"""Training: the train loop and ``python -m odtpu_torch.train``.

The loop (:func:`fit`) is the counterpart of ``train.py:240-333``: the
train step over the loader until ``TRAIN.MAX_ITER``; the loss and
images/s every ``LOG_LOSS_ITER`` steps, read from the step before, so
that each read waits for that step and the images/s window is measured
on the device's clock; a checkpoint every ``SAVE_ITER`` steps and at the
end; a validation every ``EVAL_ITER`` steps and at the end, through the
serving path's eval step (the CUDA NMS kernel on a card), which runs the
model in eval mode and hands it back in train mode: batch norm validates
with its running statistics and leaves them as they are. Saves and
validations restart the throughput window. Resume and auto-resume read
``<out_dir>/ckpt``. Losses, images/s, the step's host time
(``train/time``, a ``Timer``'s last reading) and mAP go to TensorBoard
when a writer is given, with the validation's images under the
``LOG.SHOW_*`` flags, and ``profile_dir`` takes a ``torch.profiler``
trace of steps 11-20 with the port's spans over them (``spans.json``).

The command line (``train.py:114``)::

    python -m odtpu_torch.train --cfg_name ssd_vgg16_voc [--job_group base]
        [--resume DIR | --auto_resume] [--basenet NPZ] [--output_dir DIR]
        [--max_iter N] [--profile_dir DIR] [--max_rss_gb GB]
        [--device cuda]

trains on ``DATASET.DATASET_DIR`` (``data/<SUB_DIR>`` under the checkout)
into ``--output_dir`` (default ``weights/<job_group>/<cfg_name>``), with
TensorBoard under ``logs/<job_group>_<cfg_name>``. The configuration is
one of ``utils.config.CFGS`` by name, or any yml by its path (``--cfg``,
read by ``utils.yml``, laid over the defaults as ``odtpu`` lays it). The
port writes no yaml: the run's configuration is archived as
``config_used.json`` (``odtpu`` writes ``config_used.yml``). At the
end of a run (``backup_jobs``, ``train.py:330-358``) that file and the
TensorBoard directory are copied to
``GENERAL.HISTORY_ROOT/<job_group>/<cfg_name>``, or to its first free
``_n`` when it exists.

The ``LOG.SHOW_*`` flags log images to TensorBoard (``utils/visualize.py``;
they need the ``tensorboard`` package, else nothing is written):
``SHOW_AUG_STEPS`` the first 8 train items after each augmentation stage,
``SHOW_ANCHOR_MAPS`` each feature map's anchors, one image an anchor slot,
``SHOW_TEST_IMAGE`` the first eval batch's detections,
``SHOW_PR_CURVE`` VOC's per-class PR curves; ``SHOW_SALIENCY`` is
``python -m odtpu_torch.train_debug``'s.

Over N cards, one process a card (``train.py:49-51``, ``:118-121``),
on a ``(data, model, spatial)`` mesh of N ranks::

    python -m torch.distributed.run --nproc_per_node N \
        -m odtpu_torch.train --multihost --cfg_name ssd_vgg16_voc \
        [--mesh_model M] [--mesh_spatial S] ...

``--multihost`` joins the process group that ``torch.distributed.run``
describes (NCCL; ``--device cuda`` is ``cuda:LOCAL_RANK``).
``--mesh_model`` and ``--mesh_spatial`` set ``TPU.MESH_MODEL`` (each
conv of at least 512 output channels split over M ranks) and
``TPU.MESH_SPATIAL`` (every map's rows split over S ranks); the data
axis takes the rest, D = N / (M * S) (``parallel.make_mesh``). Each data
index loads its slice of the data with its share of
``TRAIN_BATCH_SIZE``, the global batch. A step of N ranks is the
one-process step on the global batch (``train_step``); every data index
validates its slice and every rank scores the global mAP; rank 0 writes
the checkpoints (full tensors, gathered), TensorBoard, the trace and the
per-step lines.

``--max_rss_gb`` (``train.py:54-61``, ``:294-312``; default
``ODTPU_MAX_RSS_GB``, else 64; 0 disables) is a ceiling on the host's
resident memory: at a save before the last step, a process over it
prints so and replaces itself (``os.execv``) by ``python -m
odtpu_torch.train`` with its own arguments, any ``--basenet`` or
``--resume`` taken out and ``--resume <output_dir>/ckpt`` added
(:func:`_resume_argv`). It frees whatever the process held and goes on
from the checkpoint just written. A run of several processes skips it:
one rank's re-exec would leave the others waiting in a collective.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch

from . import parallel, trace
from .data import dataset_factory
from .eval.evaluator import eval_solver_factory
from .eval_step import make_eval_step
from .models import probe_layer_dims
from .ops.priors import PriorBoxSSD
from .train_step import create_train_state, make_train_step
from .utils.checkpoint import Checkpointer, load_basenet
from .utils.config import resolve_cfg_args
from .utils.logging import TBWriter, Timer
from .utils.visualize import viz_prior_anchors

# a --profile_dir trace starts when the first count of updates is done and
# stops at the second: steps 11-20, as train.py:249-255 traces them
PROFILE_STEPS = (10, 20)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Trace:
    """A ``torch.profiler`` trace of the steps of :data:`PROFILE_STEPS`,
    written to ``<profile_dir>/trace.json`` (Chrome trace format), and
    the port's tracer over the same steps, its ``summary()`` written to
    ``<profile_dir>/spans.json`` (``odtpu_torch.trace``)."""

    def __init__(self, profile_dir, device):
        self.dir, self.device, self.prof = profile_dir, device, None

    def before_step(self, it):
        if self.dir and it == PROFILE_STEPS[0] and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            trace.reset()
            trace.enable(cuda=self.device.type == "cuda")

    def stop(self):
        if self.prof is None:
            return
        _sync(self.device)
        spans = trace.summary()
        trace.disable()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(os.path.join(self.dir, "spans.json"), "w") as f:
            json.dump(spans, f, indent=1)
        self.prof = None
        print("profiler trace and spans written to", self.dir, flush=True)


def _rss_gb() -> float:
    """This process's resident memory in GB (``VmRSS`` of
    ``/proc/self/status``), as ``train.py`` reads it."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / (1024.0 ** 2)
    return 0.0


def _resume_argv(argv, ckpt_dir) -> list:
    """``argv`` with any ``--basenet``/``--resume`` (either form) taken
    out and ``--resume ckpt_dir`` added: the checkpoint carries the whole
    train state, so a re-exec must not import the basenet again."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--basenet", "--resume"):
            skip = True
            continue
        if a.startswith(("--basenet=", "--resume=")):
            continue
        out.append(a)
    return out + ["--resume", str(ckpt_dir)]


def fit(cfg, train_loader, eval_solver, out_dir, device="cuda", seed=0,
        resume="", auto_resume=False, basenet="", tb_writer=None,
        profile_dir="", max_rss_gb=0.0, argv=()) -> dict:
    """Train from seeded weights (or ``basenet``, or a checkpoint) to
    ``cfg.TRAIN.MAX_ITER``.

    ``train_loader`` yields dict batches (``images``, ``boxes``,
    ``labels``: see ``odtpu_torch.data.loader.DetLoader``);
    ``eval_solver`` is an ``odtpu_torch.eval.evaluator.EvalVOC`` or
    ``EvalCOCO``; ``tb_writer`` a ``utils.logging.TBWriter``. Returns
    the final step, the logged losses, each validation's step, mAP and
    dropped count, the checkpoint steps on disk and the
    :class:`~odtpu_torch.train_step.TrainState`.

    On a mesh (``parallel``) every rank calls it with its data index's
    loader shard and its evaluator: the steps are the global batch's, the
    ranks start from the weights of the ranks at ``d = 0, s = 0``, every
    rank validates, and only rank 0 prints, writes checkpoints,
    TensorBoard and the trace. The images/s are the global batch's.

    ``max_rss_gb`` (0: off; one process only): past that much resident
    memory at a save before the last step, the process re-executes
    ``python -m odtpu_torch.train`` with ``argv``, the command line's
    arguments, resuming from the checkpoint just written.
    """
    device = torch.device(device)
    out_dir = Path(out_dir)
    rank0 = parallel.is_main()
    say = print if rank0 else (lambda *a, **k: None)
    ckpt = Checkpointer(out_dir / "ckpt")
    if auto_resume and not resume and ckpt.latest_step() is not None:
        resume = str(ckpt.directory)
        say("auto-resume: checkpoint found under", resume, flush=True)

    state, priors = create_train_state(cfg, device, seed)
    if basenet:
        scheme, loaded, skipped = load_basenet(state.model, basenet)
        say("basenet import ({}): {} loaded, {} skipped".format(
            scheme, len(loaded), len(skipped)), flush=True)
    if resume:
        Checkpointer(resume).restore(state)
        say("resumed at step", state.step, flush=True)
    parallel.broadcast_state(state.model)
    step_fn = make_train_step(priors, cfg)
    eval_fn = make_eval_step(state.model, priors, cfg)

    max_iter = int(cfg.TRAIN.MAX_ITER)
    log_every = int(cfg.TRAIN.LOG_LOSS_ITER)
    save_every = int(cfg.TRAIN.SAVE_ITER)
    eval_every = int(cfg.TRAIN.EVAL_ITER)
    if len(train_loader) == 0:
        raise ValueError("the train loader yields no batch")
    out = {"losses": [], "evals": []}
    if not rank0:
        tb_writer, profile_dir = None, ""

    start = it = state.step
    last_log_iter, last_log_time = it, time.time()
    timer = Timer()  # the host time of one pass of the loop
    pending = None  # (step, metrics) not read yet
    profile = _Trace(profile_dir, device)
    while it < max_iter:
        for batch in train_loader:
            if it >= max_iter:
                break
            profile.before_step(it)
            timer.tic()
            metrics = step_fn(state, torch.from_numpy(batch["images"]),
                              torch.from_numpy(batch["boxes"]),
                              torch.from_numpy(batch["labels"]))
            it = state.step
            if it == start + 1:
                # the first window starts after the first step's set-up
                _sync(device)
                last_log_iter, last_log_time = it, time.time()
            if pending is not None and pending[0] % log_every == 0:
                m = {k: float(v) for k, v in pending[1].items()}
                now = time.time()
                ips = ((pending[0] - last_log_iter)
                       * batch["images"].shape[0] * parallel.data_world()
                       / max(now - last_log_time, 1e-9))
                last_log_iter, last_log_time = pending[0], now
                out["losses"].append({"step": pending[0], **m, "ips": ips})
                say("iter {} | loss {:.4f} (loc {:.4f} conf {:.4f}) | "
                    "{:.1f} img/s".format(pending[0], m["loss"],
                                          m["loss_loc"], m["loss_conf"],
                                          ips), flush=True)
                if tb_writer is not None:
                    tb_writer.add_scalars("train", {
                        "loss": m["loss"], "loc_loss": m["loss_loc"],
                        "conf_loss": m["loss_conf"],
                        "img_per_sec": ips, "time": timer.diff},
                        pending[0])
            pending = (it, metrics)
            timer.toc(average=False)
            if it == PROFILE_STEPS[1]:
                profile.stop()

            save = it % save_every == 0 or it == max_iter
            validate = it % eval_every == 0 or it == max_iter
            if save or validate:
                # the img/s window leaves out the save and the validation
                _sync(device)
                paused = time.time()
                if save:
                    ckpt.save(it, state)
                    say("saved checkpoint at", it, flush=True)
                    if (max_rss_gb and it < max_iter
                            and _rss_gb() > max_rss_gb):
                        print("RSS {:.1f} GB > --max_rss_gb {:.0f}; "
                              "re-exec with --resume at iter {}".format(
                                  _rss_gb(), max_rss_gb, it), flush=True)
                        if tb_writer is not None:
                            tb_writer.close()
                        os.execv(sys.executable, [
                            sys.executable, "-m", "odtpu_torch.train",
                            *_resume_argv(argv, out_dir / "ckpt")])
                if validate:
                    _, maps = eval_solver.validate(eval_fn,
                                                   tb_writer=tb_writer)
                    dropped = eval_solver.last_timing["dropped_dets"]
                    out["evals"].append({"step": it, "mAP": maps[0],
                                         "maps": maps, "dropped": dropped})
                    say("iter {} | mAP {}".format(it, maps), flush=True)
                    if tb_writer is not None:
                        tb_writer.add_scalar("mAP/mAP@0.5", maps[0], it)
                        if len(maps) > 1:
                            tb_writer.add_scalar("mAP/mAP@[.5:.95]",
                                                 maps[1], it)
                last_log_time += time.time() - paused
    profile.stop()

    ckpt.save(max_iter, state, force=True)
    out.update(step=it, state=state, ckpt_steps=ckpt.all_steps())
    say("done at iter", it, flush=True)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="odtpu_torch training")
    p.add_argument("--cfg_name", default="",
                   help="one of utils.config.CFGS, or cfgs/<job_group>/"
                        "<cfg_name>.yml (default ssd_vgg16_voc); with "
                        "--cfg, only the run's name")
    p.add_argument("--job_group", default="", help="default: base")
    p.add_argument("--cfg", default="",
                   help="the path of any yml, laid over the defaults")
    p.add_argument("--resume", default="", help="checkpoint dir to resume")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from <output_dir>/ckpt when it holds a "
                        "checkpoint, else start fresh (with --basenet)")
    p.add_argument("--basenet", default="",
                   help="backbone or full-model npz (odtpu's layout)")
    p.add_argument("--output_dir", default="")
    p.add_argument("--max_iter", type=int, default=0,
                   help="override TRAIN.MAX_ITER")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of steps 11-20 "
                   "there (trace.json) and the port's spans over them "
                   "(spans.json)")
    p.add_argument("--device", default="cuda",
                   help="with --multihost, cuda is cuda:LOCAL_RANK")
    p.add_argument("--max_rss_gb", type=float,
                   default=float(os.environ.get("ODTPU_MAX_RSS_GB", 64)),
                   help="host-RSS ceiling: at the next save past it, "
                        "re-exec with --resume from that checkpoint "
                        "(default ODTPU_MAX_RSS_GB, else 64; 0 disables; "
                        "one process only)")
    add_mesh_args(p)
    args = p.parse_args(argv)
    # the arguments as given, for a re-exec under --max_rss_gb
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def add_mesh_args(p) -> None:
    """``--multihost`` and the mesh's sizes, for the train and eval
    command lines."""
    p.add_argument("--multihost", action="store_true",
                   help="run over the processes that python -m "
                        "torch.distributed.run starts, one a card, on a "
                        "(data, model, spatial) mesh: each data index "
                        "loads its slice of the data")
    p.add_argument("--mesh_model", type=int, default=0,
                   help="TPU.MESH_MODEL: ranks that split each conv of at "
                        "least 512 output channels (default: the yml's, "
                        "else 1)")
    p.add_argument("--mesh_spatial", type=int, default=0,
                   help="TPU.MESH_SPATIAL: ranks that split every map's "
                        "rows (default: the yml's, else 1)")


def apply_mesh_args(args, cfg) -> None:
    """Set ``cfg.TPU.MESH_MODEL`` and ``MESH_SPATIAL`` from the command
    line where it gives them (a flag wins over the yml), then lay out the
    run's mesh (``parallel.make_mesh``): the sizes must make up the
    world."""
    if args.mesh_model:
        cfg.TPU.MESH_MODEL = args.mesh_model
    if args.mesh_spatial:
        cfg.TPU.MESH_SPATIAL = args.mesh_spatial
    parallel.make_mesh(cfg, args.device)


def setup(args):
    """(cfg, out_dir, log_dir) of the run ``args`` ask for; the caller may
    change the cfg (a dataset directory, say) before :func:`run`. The
    mesh (``--mesh_model``, ``--mesh_spatial``, in the process group of
    ``parallel.distributed``) must make up the world."""
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    cfg = resolve_cfg_args(args)
    if args.max_iter:
        cfg.TRAIN.MAX_ITER = args.max_iter
    apply_mesh_args(args, cfg)
    out = args.output_dir or os.path.join(cfg.GENERAL.WEIGHTS_ROOT,
                                          args.job_group, args.cfg_name)
    if os.path.isdir(out) and os.listdir(out) and parallel.is_main() \
            and not (args.resume or args.auto_resume):
        print("WARNING: output dir {} already exists: checkpoints and logs "
              "may be overwritten".format(out))
    os.makedirs(out, exist_ok=True)
    log_dir = os.path.join(cfg.LOG.ROOT_DIR,
                           "{}_{}".format(args.job_group, args.cfg_name))
    return cfg, out, log_dir


def _plain(x):
    """A config tree as JSON's types."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def run(args, cfg, out_dir, log_dir, tb_writer=None) -> dict:
    """Train ``cfg`` as ``args`` say: both loaders from
    ``dataset_factory``, the evaluator from ``eval_solver_factory``,
    TensorBoard under ``log_dir`` (or ``tb_writer``, a
    ``utils.logging.TBWriter`` of the caller's), the images the
    ``LOG.SHOW_*`` flags ask for, and the run archived by
    :func:`backup_jobs` on rank 0; returns :func:`fit`'s result."""
    # the run's configuration, archived up front so a crash leaves it
    if parallel.is_main():
        with open(os.path.join(out_dir, "config_used.json"), "w") as f:
            json.dump(_plain(cfg), f, indent=1)
    train_loader = dataset_factory("train", cfg)
    solver = eval_solver_factory(dataset_factory("eval", cfg), cfg,
                                 os.path.join(out_dir, "eval"))
    tb = TBWriter(log_dir) if tb_writer is None else tb_writer
    if cfg.LOG.SHOW_AUG_STEPS:
        # per-stage augmentation dumps (ref augmentations.py:395-404)
        train_loader.transform.attach_writer(tb)
    if cfg.LOG.SHOW_ANCHOR_MAPS and parallel.is_main():
        # per-feature-map anchor renderings (ref prior_box.py:55-90)
        viz_prior_anchors(PriorBoxSSD(cfg), probe_layer_dims(cfg), tb)
    try:
        out = fit(cfg, train_loader, solver, out_dir, device=args.device,
                  resume=args.resume, auto_resume=args.auto_resume,
                  basenet=args.basenet, tb_writer=tb,
                  profile_dir=args.profile_dir,
                  max_rss_gb=(0.0 if args.multihost or parallel.world() > 1
                              else args.max_rss_gb),
                  argv=args.argv)
    finally:
        tb.close()
    if parallel.is_main():
        out["history"] = backup_jobs(cfg, out_dir, log_dir, args)
    return out


def backup_jobs(cfg, out_dir, log_dir, args) -> str:
    """Archive the run's ``config_used.json`` (as ``<cfg_name>.json``) and
    its TensorBoard directory to ``HISTORY_ROOT/<job_group>/<cfg_name>``,
    or to its first free ``_n`` when that exists (reference backup_jobs,
    train.py:197-208, and ``odtpu``'s train.py:330-358); returns the
    directory."""
    dst = os.path.join(cfg.GENERAL.HISTORY_ROOT, args.job_group,
                       args.cfg_name)
    if os.path.exists(dst):
        # the first free numbered suffix, so a third run of the same cfg
        # never merges into an earlier backup
        n = 1
        while os.path.exists("{}_{}".format(dst, n)):
            n += 1
        dst = "{}_{}".format(dst, n)
        print("history dir exists; backing up as", dst)
    os.makedirs(dst, exist_ok=True)
    cfg_file = os.path.join(out_dir, "config_used.json")
    if os.path.isfile(cfg_file):
        shutil.copyfile(cfg_file, os.path.join(dst, args.cfg_name + ".json"))
    if os.path.isdir(log_dir):
        shutil.copytree(log_dir, dst, dirs_exist_ok=True)
    print("backed up cfg and TB logs to", dst)
    return dst


def main(argv=None) -> dict:
    args = parse_args(argv)
    with parallel.distributed(args):
        return run(args, *setup(args))


if __name__ == "__main__":
    main()
