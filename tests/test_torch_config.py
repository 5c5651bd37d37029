"""The port's yml reader and config overlay (``odtpu_torch.utils.yml``,
``utils.config``) against PyYAML and ``odtpu.utils.config``, on the CPU.

- Every yml under ``cfgs/`` reads as ``yaml.safe_load`` reads it, and
  the port's ``load_cfg(path)`` equals ``odtpu``'s leaf by leaf, types
  included.
- Crafted snippets, one a corner of YAML 1.1 as PyYAML resolves it, read
  as ``yaml.safe_load`` reads them; each construct outside the reader's
  subset raises with its line.
- An unknown key and a type mismatch raise ``odtpu``'s errors, with its
  messages; the two default trees have the same keys; a mesh flag on
  the command line wins over the yml's; every entry point that takes
  ``--cfg`` builds the tree of a yml given by its path.
"""

import argparse
import glob
import importlib
import math
import os

import pytest
import yaml

from odtpu.utils import config as jconfig
from odtpu_torch import parallel
from odtpu_torch.eval import cli
from odtpu_torch.utils import config, yml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "cfgs", "**", "*.yml"), recursive=True))


def _same(a, b):
    """Equal values of the same types, all the way down (a NaN equals a
    NaN)."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + key + ".")
        else:
            yield prefix + key, value


def test_every_yml_of_the_checkout_is_tested():
    assert len(YMLS) == 22


@pytest.mark.parametrize("path", YMLS)
def test_yml_reads_as_safe_load_and_loads_as_odtpu(path):
    path = os.path.join(ROOT, path)
    with open(path) as f:
        assert _same(yml.load(path), yaml.safe_load(f))
    got = dict(_leaves(config.load_cfg(path)))
    want = dict(_leaves(jconfig.load_cfg(path)))
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert _same(got[key], value), (key, got[key], value)


SNIPPETS = {
    "booleans": "a: on\nb: Off\nc: YES\nd: no\ne: True\nf: y\ng: tRue",
    "exponent_without_dot": "a: 1e-3\nb: 1.5e3\nc: 1.0e-3",
    "int_bases": "a: 0o17\nb: 0x1f\nc: 017\nd: 0b101\ne: 08\nf: 1:30",
    "underscores": "a: 1_000\nb: 1__0\nc: 1_0.5",
    "signs_and_special_floats": "a: +12\nb: -0\nc: .5\nd: -.inf\ne: 1.",
    "nulls": "a: ~\nb: null\nc:\nd: ''",
    "hash_inside_quotes": "a: 'x #c'\nb: \"y #d\" # e\nc: z #f",
    "plain_with_commas_and_quotes": (
        "A:\n  TRAIN_SETS: (('2007', 'trainval'), ('2012', 'trainval'))\n"
        "  B: x,y(z)'w'\n  C: http://h:8/p"),
    "nested_flow": "a: [[2], [2, 3]]\nb: {x: [1, 2], y: }\nc: []\nd: {}",
    "flow_over_lines": "a: [1,\n  2,  # two\n  3]\nb: 2",
    "quoting_and_escapes": ("a: 'it''s'\nb: \"t\\tu\\u00e9\\x41\\\\\"\n"
                            "'q k': 1\n\"r\": [\"e]\", 'f, g']"),
    "blank_lines_and_comments": (
        "# top\n\nA:\n\n  # inside\n  B: 1   \n\n  C: 2\n# end\n"),
    "block_sequences": "a:\n- 1\n- b: 1\n  c: 2\n- - x\n  - y\nd:\n  -\n"
                       "    e: 3",
    "document_markers": "--- # doc\na: 1\n...\n# after",
    "empty_document": "# only a comment\n",
    "top_level_sequence": "- [1, 2]\n- {a: b}\n- plain text",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_reads_as_safe_load(name):
    text = SNIPPETS[name]
    assert _same(yml.loads(text), yaml.safe_load(text)), name


REFUSED = {
    "anchor_and_alias": ("a: 1\nb: &x 2\nc: *x", 2, "an anchor"),
    "alias": ("a: 1\nb: *x", 2, "an alias"),
    "tag": ("a: 1\nb: !!str 1", 2, "a tag"),
    "literal_block": ("a: |\n  x", 1, "a block scalar"),
    "folded_block": ("a: 1\nb: >\n  x", 2, "a block scalar"),
    "second_document": ("a: 1\n---\nb: 2", 2, "a second document"),
    "tab_indentation": ("a:\n\tb: 1", 2, "a tab in the indentation"),
    "complex_key": ("? a\n: b", 1, "a complex key"),
    "timestamp": ("a: 1\nb: 2001-12-14", 2, "a timestamp"),
    "directive": ("%YAML 1.1\n---\na: 1", 1, "a directive"),
    "quoted_over_lines": ("a: 'x\n  y'", 1, "over several lines"),
    "plain_over_lines": ("a: x\n  y", 2, "over several lines"),
    "unclosed_flow": ("a: 1\nb: [1, 2", 2, "unclosed"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_construct_names_its_line(name):
    text, line, what = REFUSED[name]
    with pytest.raises(yml.YmlError, match="^t.yml:{}: .*{}".format(
            line, what)):
        yml.loads(text, "t.yml")


@pytest.mark.parametrize("text,error", [
    ("TRAIN:\n  OPTIMIZER:\n    CLIP_NORM: 1.0\n", KeyError),
    ("DATASET:\n  NUM_CLASSES: [20]\n", ValueError),
    ("TPU:\n  REMAT: 'yes'\n", ValueError),
])
def test_merge_errors_are_odtpus(tmp_path, text, error):
    """An unknown key and a type mismatch raise ``odtpu``'s error with
    ``odtpu``'s message (``'yes'`` quoted is a string, not a bool)."""
    path = tmp_path / "bad.yml"
    path.write_text(text)
    with pytest.raises(error) as want:
        jconfig.load_cfg(str(path))
    with pytest.raises(error) as got:
        config.load_cfg(str(path))
    assert got.value.args == want.value.args
    assert str(got.value.args[0]).startswith(
        ("Non-existent config key: ", "Type mismatch ("))


def test_default_trees_have_odtpus_keys():
    got = dict(_leaves(config.default_cfg()))
    want = dict(_leaves(jconfig.load_cfg()))
    assert got.keys() == want.keys()
    for key in ("EVAL.COMPACT", "DATASET.PROB", "GENERAL.JOB_GROUP",
                "TRAIN.RESUME", "TRAIN.BASENET_WEIGHTS",
                "TRAIN.LR_SCHEDULER.SCHEDULER"):
        assert _same(got[key], want[key]), key


def test_a_mesh_flag_wins_over_the_yml(tmp_path):
    """A yml's ``TPU.MESH_MODEL: 2`` reaches the key (one process cannot
    make that mesh), and ``--mesh_model 1`` overrides it."""
    path = tmp_path / "tp.yml"
    path.write_text("TPU:\n  MESH_MODEL: 2\n  REMAT: on\n")
    argv = ["--cfg", str(path), "--device", "cpu"]
    try:
        with pytest.raises(ValueError, match="x 2 x 1 but the run has 1 "):
            cli.setup(cli.parse_args(argv))
        cfg = cli.setup(cli.parse_args(argv + ["--mesh_model", "1"]))
    finally:
        parallel.shutdown()
    assert cfg.TPU.MESH_MODEL == 1 and cfg.TPU.REMAT is True


class _Read(Exception):
    """Raised by the recording reader once an entry has its tree."""


ENTRIES = {
    "train": ("odtpu_torch.train", lambda m, y: m.main(
        ["--cfg", y, "--device", "cpu"])),
    "eval": ("odtpu_torch.eval.cli", lambda m, y: m.main(
        ["--cfg", y, "--device", "cpu"])),
    "infer": ("odtpu_torch.infer", lambda m, y: m.main(
        ["--cfg", y, "--device", "cpu"])),
    "serve": ("odtpu_torch.serve", lambda m, y: m.main(
        ["--cfg", y, "--device", "cpu"])),
    "export": ("odtpu_torch.utils.config", lambda m, y: __import__(
        "odtpu_torch.export", fromlist=["main"]).main(
        ["export", "--out", "never.zip", "--cfg", y, "--device", "cpu"])),
    "train_debug": ("odtpu_torch.train_debug", lambda m, y: m.main(
        ["--cfg", y, "--device", "cpu"])),
    "demo": ("odtpu_torch.demo", lambda m, y: m.detector(argparse.Namespace(
        cfg=y, device="cpu", ckpt="", npz="", seed=0))),
    "ckpt_to_npz": ("odtpu_torch.tools.ckpt_to_npz", lambda m, y: m.main(
        ["--cfg", y, "--ckpt", "never", "--out", "never.npz"])),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_entry_point_reads_a_yml_path(entry, tmp_path, monkeypatch):
    """Each command line given ``--cfg`` with the path of a yml outside
    ``cfgs/`` builds the tree of that yml (stopped once it has it)."""
    path = tmp_path / "mine.yml"
    path.write_text("TRAIN:\n  OPTIMIZER:\n    CLIP_GRAD_NORM: 7.5\n"
                    "EVAL: {TOP_K: 50}\n")
    where, call = ENTRIES[entry]
    module = importlib.import_module(where)
    seen = []

    def recording(read):
        def call(*args):
            seen.append(read(*args))
            raise _Read
        return call

    for read in ("resolve_cfg_args", "load_cfg"):
        if hasattr(module, read):
            monkeypatch.setattr(module, read,
                                recording(getattr(module, read)))
    with pytest.raises(_Read):
        call(module, str(path))
    assert seen[0].TRAIN.OPTIMIZER.CLIP_GRAD_NORM == 7.5
    assert seen[0].EVAL.TOP_K == 50
