"""``python -m odtpu_torch.train`` and ``python -m odtpu_torch.eval`` on the
CPU, at full width (SSD300-VGG16) on a small seeded VOC tree.

The train command line runs through ``setup``/``run`` (so that the test
points the cfg at its tree, a batch of 2 and float32): 2 steps from a
``--basenet`` npz, then ``--auto_resume`` to 4. The eval command line
then scores the last checkpoint. Held exactly: its mAP and the
per-class detection files it writes equal those of the train run's last
validation (the same weights, the same eval step, the same images).
``--quant int8`` scores the same checkpoint in int8 convs.
``--max_rss_gb`` re-executes the command line as ``odtpu``'s does (with
``os.execv`` patched), and ``serve.build_engine(ckpt=)`` serves the
train run's checkpoint.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from odtpu_torch import serve, train
from odtpu_torch.data.augment import resize_u8
from odtpu_torch.eval import cli
from odtpu_torch.infer import Detector, random_images, random_state_dict
from odtpu_torch.ops import quant
from odtpu_torch.utils import logging as tlogging
from odtpu_torch.utils.checkpoint import Checkpointer
from odtpu_torch.utils.config import load_cfg, resolve_cfg_args

from synth import make_voc
from torch_tmp import drop_module_tmp  # noqa: F401

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _point_at(cfg, voc):
    cfg.DATASET.DATASET_DIR = voc
    cfg.GENERAL.HISTORY_ROOT = os.path.join(os.path.dirname(voc), "history")
    cfg.DATASET.TRAIN_SETS = (("2007", "trainval"),)
    cfg.DATASET.TRAIN_BATCH_SIZE = 2
    cfg.DATASET.EVAL_BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.SAVE_ITER = 1
    cfg.TRAIN.EVAL_ITER = 2
    cfg.TRAIN.LOG_LOSS_ITER = 1
    cfg.TRAIN.OPTIMIZER.LR = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    voc = str(work / "voc")
    make_voc(voc, setname="trainval", n_images=4, seed=0, min_size=150,
             max_size=420)
    make_voc(voc, setname="test", n_images=4, seed=1, start_id=4)
    # the basenet: the served seeded weights' conv1_1, so boxes stay finite
    w = random_state_dict(load_cfg(), seed=0)["backbone.conv1_1.conv.weight"]
    basenet = str(work / "basenet.npz")
    np.savez(basenet, **{"conv1_1/kernel": w.permute(2, 3, 1, 0).numpy()})
    out, logs = str(work / "out"), str(work / "logs")
    results, execs = [], []
    with pytest.MonkeyPatch.context() as mp:
        # --max_rss_gb 0: never a re-exec, whatever the process holds
        mp.setattr(train.os, "execv", lambda *a: execs.append(a))
        for argv in (["--max_iter", "2", "--basenet", basenet],
                     ["--max_iter", "4", "--auto_resume", "--max_rss_gb",
                      "0"]):
            args = train.parse_args(["--device", "cpu", "--output_dir",
                                     out] + argv)
            cfg, out_dir, _ = train.setup(args)
            _point_at(cfg, voc)
            results.append(train.run(args, cfg, out_dir, logs))
    eargs = cli.parse_args(["--device", "cpu", "--ckpt",
                            os.path.join(out, "ckpt"), "--output_dir",
                            str(work / "eval")])
    ecfg = cli.setup(eargs)
    _point_at(ecfg, voc)
    scored = cli.run(eargs, ecfg)
    return {"work": work, "out": out, "logs": logs, "train": results,
            "eval": scored, "basenet": basenet, "execs": execs}


def test_train_command_line_trains_saves_and_resumes(runs):
    first, second = runs["train"]
    assert first["step"] == 2 and second["step"] == 4
    assert [e["step"] for e in first["evals"]] == [2]
    assert [e["step"] for e in second["evals"]] == [4]
    assert second["ckpt_steps"] == [1, 2, 3, 4]
    assert [m["step"] for m in second["losses"]] == [3]  # read a step late
    for m in first["losses"] + second["losses"]:
        assert np.isfinite(m["loss"]) and m["num_pos"] > 0
    used = json.load(open(os.path.join(runs["out"], "config_used.json")))
    assert used["DATASET"]["DATASET_DIR"].endswith("voc")
    assert used["TPU"]["COMPUTE_DTYPE"] == "float32"
    assert used["DATASET"]["TRAIN_SETS"] == [["2007", "trainval"]]


def test_max_rss_gb_reexecs_with_resume_as_odtpu(runs, tmp_path, capsys,
                                                 monkeypatch):
    """Over ``--max_rss_gb`` at the first save (step 1 of 2), the process
    re-executes ``python -m odtpu_torch.train`` with its arguments, the
    ``--basenet`` taken out and ``--resume <output_dir>/ckpt`` added by
    the rules of ``odtpu``'s ``_resume_argv`` (root ``train.py``; the
    check ``tests/test_integration.py`` makes of ``odtpu``), after
    writing that checkpoint. ``--max_rss_gb 0`` (the fixture's second
    run, 4 saves) never does."""
    assert runs["execs"] == []
    import train as odtpu_train  # the root script

    class Exec(Exception):
        pass

    calls = {}

    def execv(exe, argv):
        calls["exe"], calls["argv"] = exe, argv
        raise Exec()

    monkeypatch.setattr(train.os, "execv", execv)
    monkeypatch.setenv("ODTPU_MAX_RSS_GB", "7")
    out = str(tmp_path / "out")
    argv = ["--device", "cpu", "--output_dir", out, "--max_iter", "2",
            "--basenet", runs["basenet"], "--max_rss_gb", "0.01"]
    args = train.parse_args(argv)
    assert train.parse_args([]).max_rss_gb == 7.0
    cfg, out_dir, _ = train.setup(args)
    _point_at(cfg, str(runs["work"] / "voc"))
    capsys.readouterr()
    with pytest.raises(Exec):
        train.run(args, cfg, out_dir, str(tmp_path / "logs"))
    said = capsys.readouterr().out
    assert "re-exec with --resume at iter 1" in said
    assert calls["exe"] == sys.executable
    ckpt = os.path.join(out, "ckpt")
    assert calls["argv"] == [sys.executable, "-m", "odtpu_torch.train",
                             *odtpu_train._resume_argv(argv, ckpt)]
    assert calls["argv"][-2:] == ["--resume", ckpt]
    assert "--basenet" not in calls["argv"]
    assert "--max_rss_gb" in calls["argv"]
    assert os.path.isfile(os.path.join(ckpt, "1.pt"))
    for given in (["--cfg", "a.yml", "--basenet", "w.npz", "--resume=/old",
                   "--cfg_name", "x", "--basenet=other.npz"],
                  ["--resume", "/old", "--auto_resume"]):
        assert train._resume_argv(given, "/run/ckpt") \
            == odtpu_train._resume_argv(given, "/run/ckpt")


def test_serve_engine_from_a_train_checkpoint(runs):
    """``serve.build_engine(cfg, ckpt=<a checkpoint dir of the train
    command line>)``: the detections of a ``Detector`` built from that
    checkpoint's latest state dict, on a VOC-sized image."""
    ckpt = os.path.join(runs["out"], "ckpt")
    infer, names = serve.build_engine(load_cfg(), ckpt=ckpt, device="cpu")
    cfg = load_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    det = Detector(cfg, state_dict=Checkpointer(ckpt).read()["model"],
                   device="cpu")
    img = random_images(1, (375, 500), 0)[0]
    rows = det(resize_u8(img, (300, 300))[None])["rows"][0].numpy()
    want = serve.detections(rows, (375, 500), names, 0.01)
    assert want and infer(img, 0.01) == want
    with pytest.raises(ValueError, match="not both"):
        serve.build_engine(load_cfg(), npz="x.npz", ckpt=ckpt, device="cpu")


def test_eval_command_line_reproduces_the_last_validation(runs):
    scored = runs["eval"]
    last = runs["train"][1]["evals"][-1]
    assert scored["maps"] == last["maps"]
    assert scored["weights"].endswith("step 4")
    assert scored["timing"]["images"] == 4
    train_eval = Path(runs["out"]) / "eval"
    files = sorted(p.name for p in train_eval.glob("det_*.txt"))
    assert len(files) == 20
    n_rows = 0
    for name in files:
        got = (runs["work"] / "eval" / name).read_text()
        assert got == (train_eval / name).read_text(), name
        n_rows += len(got.splitlines())
    assert n_rows > 0  # the trained weights detect something


def test_tensorboard_scalars_written_when_available(runs):
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        assert not os.path.isdir(runs["logs"])
    else:
        assert any(f.startswith("events.") for f in os.listdir(runs["logs"]))


def test_tbwriter_without_tensorboard_prints_and_writes_nothing(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = tlogging.TBWriter(str(tmp_path / "tb"))
    tb.add_scalars("train", {"loss": 1.0}, 3)
    tb.close()
    assert tb.writer is None
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    assert not (tmp_path / "tb").exists()


def test_profile_trace_of_the_steps(tmp_path):
    trace = train._Trace(str(tmp_path / "prof"), torch.device("cpu"))
    trace.before_step(train.PROFILE_STEPS[0] - 1)
    assert trace.prof is None
    trace.before_step(train.PROFILE_STEPS[0])
    torch.ones(8).sum()
    trace.stop()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert (tmp_path / "prof" / "spans.json").stat().st_size > 0
    trace.stop()  # a second stop is a no-op


@pytest.mark.parametrize("argv,match", [
    (["--cfg_name", "ssd_vgg16_vox"], "not one of"),
    (["--cfg", "{tmp}/unknown_key.yml"], "Non-existent config key: "
                                         "TRAIN.OPTIMIZER.CLIP_NORM"),
    (["--cfg_name", "ssd_vgg16_coco_image512"], r"\(year, set\) pairs"),
    ([], "no CUDA device"),
])
def test_command_lines_refuse(argv, match, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "unknown_key.yml").write_text(
        "TRAIN:\n  OPTIMIZER:\n    CLIP_NORM: 10.0  # no such key\n")
    argv = [a.format(tmp=tmp_path) for a in argv]
    device = [] if match == "no CUDA device" else ["--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        train.setup(train.parse_args(argv + device + [
            "--output_dir", "/nonexistent/never"]))
    with pytest.raises(SystemExit, match=match):
        cli.setup(cli.parse_args(argv + device))


def test_eval_scores_int8_and_train_refuses_visualisation(runs, tmp_path):
    """``--quant int8`` sets TPU.QUANT and scores the last checkpoint
    with int8 convs: the same images, an mAP, a detection file a class.
    Then one train step with every TensorBoard flag but saliency on (the
    command line once refused them), into a recording writer: the
    augmentation dumps of up to 8 items, stage by stage, one anchor
    map a (source, slot), the first eval batch's 2 images, a PR curve a
    class with detections, and the run archived under HISTORY_ROOT."""
    calls = quant.INT_MM_CALLS
    eargs = cli.parse_args(["--device", "cpu", "--quant", "int8", "--ckpt",
                            os.path.join(runs["out"], "ckpt"),
                            "--output_dir", str(tmp_path / "eval8")])
    ecfg = cli.setup(eargs)
    assert ecfg.TPU.QUANT == "int8"
    _point_at(ecfg, str(runs["work"] / "voc"))
    scored = cli.run(eargs, ecfg)
    assert quant.INT_MM_CALLS > calls
    assert scored["weights"].endswith("step 4")
    assert scored["timing"]["images"] == 4
    assert all(0.0 <= m <= 1.0 for m in scored["maps"])
    assert len(list((tmp_path / "eval8").glob("det_*.txt"))) == 20
    args = train.parse_args(["--device", "cpu", "--output_dir",
                             str(tmp_path / "flags"), "--max_iter", "1"])
    cfg, out, log = train.setup(args)
    _point_at(cfg, str(runs["work"] / "voc"))
    for flag in ("SHOW_AUG_STEPS", "SHOW_ANCHOR_MAPS", "SHOW_TEST_IMAGE",
                 "SHOW_PR_CURVE"):
        cfg.LOG[flag] = True
    tb = chip_smoke.recording_writer()
    done = train.run(args, cfg, out, log, tb_writer=tb)
    assert done["step"] == 1 and len(done["evals"]) == 1
    tags = tb.writer.tags()
    stages = ("0_input", "1_photometric", "2_expand", "3_crop", "4_mirror",
              "5_resize")
    # every item the loader's threads augment until 8 are dumped: the
    # batch's 2 and those prefetched, stage by stage, interleaved
    dumps = [(t, step) for t, _, step in tb.writer.images
             if t.startswith("augmentation/")]
    items = sorted({step for _, step in dumps})
    assert 2 <= len(items) <= 8 and items == list(range(len(items)))
    assert sorted(dumps) == sorted(("augmentation/" + s, i)
                                   for i in items for s in stages)
    assert len([t for t in tags if t.startswith("base/feature_map_")]) == 30
    assert tags.count("eval/detections") == 2
    curves = tb.writer.curves
    assert curves and all(t.startswith("pr/") and len(kw["precision"])
                          for t, kw in curves)
    assert os.path.isfile(os.path.join(done["history"],
                                       "ssd_vgg16_voc.json"))


@pytest.mark.parametrize("argv,name,run", [
    ({}, "ssd_vgg16_voc", ("ssd_vgg16_voc", "base")),
    ({"cfg": "cfgs/vgg/fpn_vgg16_voc.yml"}, "fpn_vgg16_voc",
     ("fpn_vgg16_voc", "vgg")),
    ({"cfg": str(ROOT / "cfgs/base/ssd_vgg16_coco.yml"), "cfg_name": "mine"},
     "ssd_vgg16_coco", ("mine", "base")),
    ({"cfg_name": "rfbnet300_vgg16_voc", "job_group": "rfb"},
     "rfbnet300_vgg16_voc", ("rfbnet300_vgg16_voc", "rfb")),
    ({"cfg": "cfgs/tests/flagship_synth.yml"},
     str(ROOT / "cfgs/tests/flagship_synth.yml"),
     ("flagship_synth", "tests")),
])
def test_resolve_cfg_args(argv, name, run):
    """The config's tree and the run's name; a yml that no name of
    ``CFGS`` stands for is read from its path."""
    args = train.parse_args(["--{}={}".format(k, v)
                             for k, v in argv.items()])
    cfg = resolve_cfg_args(args)
    assert cfg == load_cfg(name)
    assert (args.cfg_name, args.job_group) == run
    if run[0] == "flagship_synth":
        assert cfg.TRAIN.OPTIMIZER.CLIP_GRAD_NORM == 10.0
        assert cfg.TRAIN.LR_SCHEDULER.WARMUP_ITERS == 1000
        assert cfg.TRAIN.LR_SCHEDULER.STEPS == (4000, 5000)


@pytest.mark.parametrize("module", ["odtpu_torch.train", "odtpu_torch.eval"])
def test_module_entry_points(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module, "--help"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0 and "--cfg_name" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", module, "--output_dir",
                           "/nonexistent/never"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
