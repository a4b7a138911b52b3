"""On the card: the control (the plain reference in float32 with TF32
products, put in the program's place) fails at least one of each cell's
limits, or crashes, and the program passes them, at the cell's own size
(about half a minute a cell).

Run on the card: ``python -m pytest -m cuda gpbench/tests``."""

import pytest

from gpbench.tests.conftest import bench, load, need_cuda

CELLS = [w["name"] for w in bench()["workloads"]]


def _cell(workload):
    entry = next(w for w in bench()["workloads"] if w["name"] == workload)
    return load("configs", entry["config"]), load("traffic", entry["traffic"]), load("limits", workload)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_program_passes(workload):
    need_cuda()
    import importlib

    import torch

    from gpbench.drivers import Cell
    from gpbench.reference import Precision

    cfg, traffic, limits = _cell(workload)
    cell = Cell(workload, cfg, traffic, 2**31 + 77, "cuda")
    driver = importlib.import_module(f"gpbench.drivers.{traffic['driver']}").Driver(cell)
    driver.setup()
    for i in range(int(traffic.get("check_units", traffic.get("check_requests", 1)))):
        driver.unit(i)
    got = driver.readings()
    driver.free()
    ref = driver.reference(Precision.exact())
    sound = driver.compare(got, ref)
    assert all(sound[k] <= limits[k] for k in limits), sound
    try:
        control = driver.compare(driver.reference(Precision.control(cfg["model"]["cg_tol"])), ref)
    except torch.linalg.LinAlgError:  # the TF32 Gram's Cholesky fails: the control has failed
        return
    assert any(control[k] > limits[k] for k in limits), control
