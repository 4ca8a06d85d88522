"""Each cell, at its own size, on the card: a short run comes out correct,
and its control comes out not correct (the reference on float8 products in
a training cell's place; the program's own int8 path in an evaluation
cell's). Skips without a CUDA device (the ``card`` fixture decides when it
runs)."""

import pytest

from harness import cell as run_cell
from harness import compare, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name, card):
    cell = spec.cell(name)
    out = run_cell.run(cell, 2 ** 31 + 12345, 3.0, False, device=card)
    assert out["correct"], out["checks"]
    rate = cell.generator().Driver.rate_metric
    assert out["metrics"][rate]["value"] > 0 and out["failed"] == 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    cell = spec.cell(name)
    seed = 2 ** 31 + 54321
    if cell.generator().Driver.train:
        driver = cell.generator().Driver(run_cell.Context(cell, seed, card))
        want = driver.reference_trajectory("fp32")
        readings = compare.training_gaps(driver.reference_trajectory("fp8"), want)
        assert not compare.judge(readings, cell.workload["limits"])["correct"]
    else:
        out = run_cell.run(cell, seed, 3.0, False, device=card,
                           model_overrides={"int8_matmul": True})
        assert not out["correct"], out["checks"]
