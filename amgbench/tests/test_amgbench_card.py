"""The run's probes on the card, at a size a test run holds: the
per-layer metrics, the busy share and the breakdown (``cuda``: skips
without a card)."""

import pytest

from amgbench import catalog, harness
from conftest import small_config

BENCH = catalog.benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name,grid", [
    ("aniso2d-2048.refine-f32", (256, 256)),
    ("lap27-128.refine-f32", (32, 32, 32))])
def test_a_traced_run_on_the_card(card, cell_name, grid):
    config = small_config(BENCH, cell_name, grid)
    out = harness.execute(BENCH, cell_name, 2 ** 31 + 7, 1.0, True, "cuda",
                          config=config)
    assert out["correct"]
    layer = out["per_layer"]
    wanted = {m["name"] for m in catalog.metrics_of(BENCH, "per_layer",
                                                    cell_name)}
    assert set(layer) == wanted
    assert 0 < layer["spmv_roofline_a0"] <= 105
    assert 0 < layer["device_idle"] < 100
    assert layer["vcycle_ms"] > 0 and layer["vcycle_enqueue_ms"] > 0
    assert 0 < out["busy_s"] < out["trace_window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
    assert out["memory_peak_bytes"] > 0
