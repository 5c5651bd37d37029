"""On a CUDA card, at each cell's own size: the control (a serve cell's
int8 path, a train cell's reference with fp8 convs) and a train cell's
fault "half of the batch left out" fail the cell's limits on three
seeds. Run on the card with ``python3 -m pytest -m gpu
benchmark/tests/test_benchmark_gpu.py``."""

import pytest

from benchmark import calibrate, cells, compare


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in cells.spec()[
    "workloads"]])
def test_control_fails(card, name):
    cell = cells.load(name)
    driver = cell["traffic"]["driver"]
    seeds = [calibrate.BASE_SEED + 104729 * i for i in range(3)]
    read = (calibrate.serve_readings if driver == "serve"
            else calibrate.train_readings)
    args = (cell, seeds, 3) + ((2.0,) if driver == "serve" else ())
    lines = read(*args, None, sound=False)
    assert len(lines) == 3 * (1 if driver == "serve" else 2)
    limits = cell["config"]["limits"][driver]
    for line in lines:
        ok, table = compare.verdict(line["numbers"], limits)
        assert not ok, line
