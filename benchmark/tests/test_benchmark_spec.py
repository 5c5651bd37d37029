"""``BENCHMARK.json`` keeps to its contract, and every part a cell names
is found by its name."""

import importlib.util
import json
import re

from benchmark import cells, compare

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_size_and_keys():
    raw = cells.SPEC.read_bytes()
    assert len(raw) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == TOP
    assert 1 <= len(spec["command"]) <= 32
    for word in spec["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and (cells.ROOT / p).is_dir()
        assert not p.startswith("/") and ".." not in p
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells (14 runs each) fits in 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    spec = cells.spec()
    assert 1 <= len(spec["configs"]) <= 24
    assert 1 <= len(spec["workloads"]) <= 24
    assert 1 <= len(spec["end_to_end"]) <= 16
    assert 1 <= len(spec["per_layer"]) <= 128
    files = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert c["file"] not in files and (cells.ROOT / c["file"]).is_file()
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in spec["workloads"]}
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in spec["workloads"]}) == len(
        spec["workloads"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cell_names = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cell_names
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        # the harness gives a per-layer metric to the cells it lists
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"} and m["workloads"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cell_names
            assert m["moves"] in {x["name"] for x in cells.load(w)[
                "end_to_end"]}


def test_every_cell_reports_enough():
    for w in cells.spec()["workloads"]:
        cell = cells.load(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


def test_every_part_found_by_name():
    here = cells.HERE
    for w in cells.spec()["workloads"]:
        cell = cells.load(w["name"])
        cfg, tr = cell["config"], cell["traffic"]
        assert cfg["name"] == w["config"]
        assert (here / "reference" / (cfg["family"] + ".py")).is_file()
        driver = tr["driver"]
        assert importlib.util.find_spec("benchmark." + driver) is not None
        numbers = (compare.SERVE_NUMBERS if driver == "serve"
                   else compare.TRAIN_NUMBERS)
        assert cfg["limits"][driver] and set(cfg["limits"][driver]) <= set(
            numbers)
        for m in cell["per_layer"]:
            assert (here / "metrics" / (m["name"] + ".py")).is_file()
