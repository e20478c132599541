"""The blocked (BSR) AMG solve of the port against the JAX package: the
float64 solve histories and the card's padding on the CPU, on the
hierarchies of tests/test_torch_bsr_amg.py, whose helpers this file takes
(a file of its own, so that a test run spread over files by worker runs
the two halves side by side).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bsr_amg import (  # noqa: E402
    _assert_same_history, _jax_solve, _port_dh, _port_ml, _port_solve, _rhs)

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("sweeps", [1, 3])
def test_solve_history_matches_jax(n_shards, sweeps):
    """f64 blocked V-cycles to 1e-6, b = A 1: the same cycle count and
    residual histories equal to 1e-9 relative (-1 padding included).
    Block Chebyshev(3) converges, with the host-recomputed residual below
    2e-6 (tests/test_bsr_amg.py); damped block Jacobi (sweeps 1) stops at
    the 100-cycle cap in both packages."""
    t = _port_solve(_port_dh(n_shards, sweeps))
    j = _jax_solve(n_shards, sweeps)
    _assert_same_history(t, j)
    b = _rhs(_port_ml("rs", 1))
    rel = (np.linalg.norm(b - _port_ml("rs", n_shards).levels[0].A.mult(t[0]))
           / np.linalg.norm(b))
    if sweeps == 3:
        assert j[1][j[2]] < 1e-6 and rel < 2e-6
    else:
        assert t[2] == 100 and 1e-6 < rel < 1e-3


@pytest.mark.parametrize("n_shards", [1, 4])
def test_card_padding_on_cpu_keeps_history(n_shards):
    """lane_pad=128 packs the nodal operators as the card does (BDIA at
    this size, every width a multiple of 128) and pads each component to
    those widths; its history equals lane_pad=1's to 1e-12 relative (and
    1e-15 absolute: the padded BDIA sums in another order, and a relative
    residual carries rounding of about 1e-16 of its own)."""
    dh1, dh128 = _port_dh(n_shards, 3), _port_dh(n_shards, 3, lane_pad=128)
    for lvl in dh128.levels[:-1]:
        for M in lvl.Pn + lvl.PnT:
            assert M.rows_pad % 128 == 0 and M.cols_pad % 128 == 0
    # the fine components are padded past the blocked rows
    assert dh128.levels[0].PnT[0].cols_pad > dh128.levels[0].Ab.brows_pad
    assert dh128.levels[0].Pn[0].on_format == "bdia"
    (x1, h1, k1), (x2, h2, k2) = _port_solve(dh1), _port_solve(dh128)
    assert k1 == k2
    np.testing.assert_allclose(h2, h1, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(x2, x1, rtol=0, atol=1e-12 * np.abs(x1).max())
