"""The roofline's byte count and the trace reduction on synthetic
inputs."""

import pytest

from amgbench import timing, trace


def test_spmv_bytes_counts_values_and_both_vectors_once():
    assert timing.spmv_bytes(nnz=10, rows=4, cols=5, itemsize=8) == 152
    # the 2-D flagship in float32: a 9-point stencil on 2048^2 has
    # (3 * 2048 - 2)^2 nonzeros
    nnz, n = (3 * 2048 - 2) ** 2, 2048 ** 2
    assert timing.spmv_bytes(nnz, n, n, 4) == 4 * (nnz + 2 * n)


def test_roofline_percent():
    nbytes = int(timing.PEAK_BYTES_PER_S * 1e-3)     # 1 ms at the peak
    assert timing.roofline_percent(nbytes, 2e-3) == pytest.approx(50.0)
    assert timing.roofline_percent(nbytes, 1e-3) == pytest.approx(100.0)


def test_union_clips_and_merges():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (20, 30)],
                       0.5, 25) == [[0.5, 3], [5, 9], [20, 25]]
    assert trace.union([(0, 1)], 2, 3) == []


def test_gaps_complement_the_union():
    busy = [[1, 3], [5, 9]]
    assert trace.gaps(busy, 0, 10) == [(0, 1), (3, 5), (9, 10)]
    assert trace.gaps([], 0, 4) == [(0, 4)]
    assert trace.gaps([[0, 4]], 0, 4) == []


def test_innermost_host_interval():
    host = [("solve", 0, 100), ("aten::add", 10, 20), ("aten::item", 30, 60),
            ("aten::copy_", 35, 40), ("outer", -5, 200)]
    got = trace.innermost(host, [5, 12, 20, 36, 45, 150, 300])
    assert got == ["solve", "aten::add", "solve", "aten::copy_",
                   "aten::item", "outer", None]


def test_summarize():
    device = [("k1", 10, 20), ("k2", 15, 30), ("k1", 60, 70),
              ("copy", 95, 120)]
    host = [("amgbench.solve", 0, 100), ("aten::item", 30, 55)]
    out = trace.summarize((0, 100), device, host)
    assert out["busy_s"] == pytest.approx(35e-6)          # 10-30, 60-70, 95-100
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert dict(out["device_ops"])["copy"] == pytest.approx(5e-6)
    idle = dict(out["idle_gaps"])
    # gaps 0-10 and 70-95 under the solve span, 30-60 under aten::item
    assert idle["amgbench.solve (2 gaps)"] == pytest.approx(35e-6)
    assert idle["aten::item (1 gaps)"] == pytest.approx(30e-6)
    assert sum(idle.values()) + out["busy_s"] == pytest.approx(100e-6)
