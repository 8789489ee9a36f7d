"""On the card: each cell's program passes its limits and its control (the
program's int8 path) fails one. Short windows, one seed each; ``benchmark/control.py`` takes the
readings over many seeds that the limits were set from."""

import time

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()


def _run(cell_name, seed, control=None):
    cell = harness.find(BENCH["workloads"], cell_name, "workload")
    traffic = harness.load_json("traffic", cell["traffic"])
    cfg = harness.run_config(harness.load_json("configs", cell["config"]), traffic)
    loop = harness.load_loop(traffic["loop"])
    return loop.run(cell, cfg, traffic, seed, 2.0, False, time.perf_counter(),
                    harness.load_json("limits", cell_name), control=control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_program_passes_and_control_fails(cuda, cell):
    sound = _run(cell, 2 ** 31 + 101)
    assert sound.failed == 0 and all(c.ok for c in sound.checks), [(c.name, c.value, c.limit) for c in sound.checks]
    control = _run(cell, 2 ** 31 + 102, "int8")
    assert not all(c.ok for c in control.checks), [(c.name, c.value, c.limit) for c in control.checks]
