"""The smoothed-aggregation slice of the port against the JAX package, end
to end: ``ParSmoothedAggregationSolver``'s hierarchies bit for bit, the
V-cycle solve, mixed-precision refinement and AMG-PCG on them, and the
packing of SA's transfer operators.

Problems (``_torch_parity.SA_PROBLEMS``): the 25^2 rotated anisotropic
diffusion at 4 shards (theta 0.25, SOR: tests/test_smoothed_aggregation.py::
test_sa_solver_converges's configuration) and the 24^3 and 64^3 27-point
Laplacians at 1 shard (theta 0, Chebyshev(2): bench.py:bench_sa's, cut in
size). At 64^3 only the setup and the packing are compared: its coarsest
level has one row, and its last P is 89 x 1. JAX runs on the CPU mesh of
tests/conftest.py; the port on CPU tensors, where the kernel wrappers run
their plain versions.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.krylov import cg as jcg  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu_torch import ParSmoothedAggregationSolver  # noqa: E402
from raptor_tpu_torch.core.types import RelaxType  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.krylov import cg as tcg  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)

from _torch_parity import (  # noqa: E402
    SA_PROBLEMS, jax_sa, rhs, sa_matrix, to_port)
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

# level sizes of the JAX package's SA hierarchies
LEVELS = {"aniso25": [625, 100, 19], "lap24": [13824, 361, 8],
          "lap64": [262144, 6101, 89, 1]}
PHASES = {"strength", "aggregation", "candidates", "prolongation", "RAP"}


@functools.lru_cache(maxsize=None)
def _port_sa(problem):
    _, _, theta, relax, sweeps = SA_PROBLEMS[problem]
    ml = ParSmoothedAggregationSolver(theta,
                                      relax_type=getattr(RelaxType, relax))
    ml.num_smooth_sweeps = sweeps
    ml.setup(sa_matrix(problem, tst))
    return ml


def _same_bits(t, j):
    """A port ParCSRMatrix bit-equal to a JAX-package one, partition
    included."""
    for f in ("row_bounds", "col_bounds"):
        np.testing.assert_array_equal(getattr(t.partition, f),
                                      getattr(j.partition, f))
    tg, jg = t.global_csr, j.global_csr
    assert tg.shape == jg.shape
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert tg.data.tobytes() == np.asarray(jg.data, np.float64).tobytes()


@pytest.mark.parametrize("problem", ["aniso25", "lap24", "lap64"])
def test_sa_hierarchy_bit_equal_to_jax(problem):
    """Every level's A and P with their partitions, the coarse LU, the
    carried candidates and the setup phases of every level."""
    jml, tml = jax_sa(problem), _port_sa(problem)
    assert [lv.A.global_num_rows for lv in tml.levels] == LEVELS[problem]
    assert tml.num_levels == len(jml.levels)
    for tl, jl in zip(tml.levels, jml.levels):
        _same_bits(tl.A, jl.A)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            _same_bits(tl.P, jl.P)
    for t, j in zip(tml.coarse_lu, jml.coarse_lu):
        assert np.asarray(t).tobytes() == np.asarray(j).tobytes()
    assert tml.B.tobytes() == jml.B.tobytes()
    assert ([set(d) for d in tml.setup_level_times]
            == [set(d) for d in jml.setup_level_times]
            == [PHASES] * (tml.num_levels - 1))
    assert tml.print_setup_times().splitlines()[0].split() == \
        ["level"] + sorted(PHASES)


@functools.lru_cache(maxsize=None)
def _f64_pair(problem):
    """(JAX, port) float64 device hierarchies of the problem, each from its
    own package's setup."""
    S = SA_PROBLEMS[problem][1]
    jdh = JaxDeviceHierarchy(jax_sa(problem), jpar.make_mesh(S),
                             dtype=jnp.float64, lane_pad=1)
    tdh = DeviceHierarchy(_port_sa(problem), dtype=torch.float64,
                          lane_pad=1, device="cpu")
    return jdh, tdh


@pytest.mark.parametrize("problem", ["aniso25", "lap24"])
def test_sa_solve_history_matches_jax(problem):
    """f64 V-cycles to 1e-9 with b = A 1: the same cycle count, residual
    histories equal to 1e-9 relative (entries below 1e-7 to 1e-16
    absolute: a relative residual r carries rounding of about 1e-16 / r)."""
    jdh, tdh = _f64_pair(problem)
    jdh.solve_tol = tdh.solve_tol = 1e-9
    b = rhs(jax_sa(problem), ones=True)
    jr = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    tr = tdh.solve(tdh.vector(np.zeros_like(b)), tdh.vector(b))
    assert tr.n_iters == int(jr.n_iters) > 3
    assert not tr.stalled and not bool(jr.stalled)
    np.testing.assert_allclose(tr.res, np.asarray(jr.res), rtol=1e-9,
                               atol=1e-16)
    x = tdh.host(tr.x)
    np.testing.assert_allclose(x, jdh.host(jr.x), rtol=0,
                               atol=1e-9 * np.abs(x).max())


def test_sa_solve_mixed_within_one_refinement_of_jax():
    """bench.py:bench_sa's solve at 24^3: a float32 hierarchy refined in
    float64 to 1e-8. The float32 cycles round differently in the two
    packages, so the counts may part by one."""
    jml, tml = jax_sa("lap24"), _port_sa("lap24")
    b = rhs(jml, ones=True)
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(1), dtype=jnp.float32,
                             lane_pad=1)
    tdh = DeviceHierarchy(tml, dtype=torch.float32, lane_pad=1,
                          device="cpu")
    _, jh = jdh.solve_mixed(np.zeros_like(b), b, tol=1e-8, max_iter=200)
    x, th = tdh.solve_mixed(np.zeros_like(b), b, tol=1e-8, max_iter=200)
    assert th[-1] <= 1e-8 and jh[-1] <= 1e-8
    assert abs((len(th) - 1) - (len(jh) - 1)) <= 1
    a = tml.levels[0].A.global_csr
    assert np.linalg.norm(b - a.mult(x)) <= 1e-8 * np.linalg.norm(b)


def test_sa_pcg_matches_jax():
    """AMG-PCG with the f64 SA V-cycle as the preconditioner, to 1e-10:
    JAX's iteration count and history."""
    jdh, tdh = _f64_pair("lap24")
    b = rhs(jax_sa("lap24"))
    jr = jcg.cg(jdh.mesh, jdh.levels[0].A, jdh.vector(np.zeros_like(b)),
                jdh.vector(b), tol=1e-10, max_iter=100,
                precond=jdh.precond_pack())
    tr = tcg.cg(tdh.levels[0].A, tdh.vector(np.zeros_like(b)),
                tdh.vector(b), tol=1e-10, max_iter=100,
                precond=tdh.precond_pack())
    assert tr.n_iters == int(jr.n_iters) > 2
    np.testing.assert_allclose(tr.res, np.asarray(jr.res), rtol=1e-9,
                               atol=1e-16 * abs(float(jr.res[0])))
    assert tr.res[tr.n_iters] <= 1e-10 * tr.res[0]


def _apply_both(m, embed, fmt, lane_pad=128, seed=0):
    """``m`` packed in float64 by both packages (``fmt`` None: each
    package's automatic pick) and applied to one seeded vector: (port's
    packed operator, port's y, JAX's y, the host product)."""
    S = m.partition.n_shards
    mesh = jpar.make_mesh(S)
    jA = jpar.device_put_matrix(m, mesh, dtype=jnp.float64,
                                lane_pad=lane_pad, embed=embed,
                                force_format=fmt, need_transpose=False)
    tA = tpar.device_put_matrix(to_port(m), dtype=torch.float64,
                                lane_pad=lane_pad, embed=embed,
                                force_format=fmt, need_transpose=False,
                                device="cpu")
    part = m.partition
    x = np.random.default_rng(seed).standard_normal(part.global_num_cols)
    jy = jpar.host_vector(np.asarray(jpar.spmv(
        mesh, jA, jpar.device_put_vector(x, part.col_bounds, jA.cols_pad,
                                         mesh))), part.row_bounds)
    ty = tpar.host_vector(tpar.spmv(
        tA, tpar.device_put_vector(x, part.col_bounds, tA.cols_pad,
                                   device="cpu")), part.row_bounds)
    return tA, ty, jy, m.global_csr.to_scipy() @ x


def _close(got, want):
    return np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# (problem, operator, forced format): the card's automatic picks at 64^3
# (BDIA for P0; for P^T the sorted scatter, without the embedding), and
# each forced transfer format at 24^3 (at 64^3 a forced BELL P^T holds
# 6 GB in f64)
TRANSFER_CASES = ([("lap64", op, None) for op in ("P0", "Pt0")]
                  + [("lap24", op, fmt) for op in ("P0", "Pt0")
                     for fmt in (None, "well", "wellt", "bell")])
AUTO = {("lap64", "P0"): ("bdia", "cols"), ("lap64", "Pt0"): ("wellt", "none"),
        ("lap24", "P0"): ("bdia", "cols"), ("lap24", "Pt0"): ("bdia", "rows")}


@pytest.mark.parametrize("problem,op,fmt", TRANSFER_CASES)
def test_sa_transfer_formats_match_host_and_jax(problem, op, fmt):
    """An SA level-0 P (embedded by columns) and P^T (by rows) at lane_pad
    128, packed automatically or in a forced format: each SpMV equals the
    host product and JAX's XLA SpMV to 1e-12 in f64."""
    p = jax_sa(problem).levels[0].P
    m, embed = (p, "cols") if op == "P0" else (p.transpose(), "rows")
    tA, ty, jy, want = _apply_both(m, embed, fmt)
    if fmt is None:
        assert (tA.on_format, tA.embed_kind) == AUTO[problem, op]
    else:
        assert tA.on_format == fmt
    assert _close(ty, want) and _close(ty, jy)


def test_sa64_coarsest_level_packs_and_applies():
    """The 64^3 hierarchy's last transfer pair (89 x 1 P, 1 x 89 P^T) and
    its one-row coarsest A pack and apply in both packages; the whole f64
    hierarchy at lane_pad 128 takes a V-cycle whose coarse solve is the
    1 x 1 LU."""
    jml = jax_sa("lap64")
    p2, a3 = jml.levels[2].P, jml.levels[3].A
    assert p2.global_csr.shape == (89, 1) and a3.global_csr.shape == (1, 1)
    for m, embed in ((p2, "cols"), (p2.transpose(), "rows"), (a3, None)):
        _, ty, jy, want = _apply_both(m, embed, None, seed=3)
        assert _close(ty, want) and _close(ty, jy)
    tdh = DeviceHierarchy(_port_sa("lap64"), dtype=torch.float64,
                          lane_pad=128, device="cpu")
    coarse = tdh.levels[-1]
    assert coarse.P is None and coarse.A.global_num_rows == 1
    assert tdh.lu.shape == (1, 1)
    bc = torch.zeros((1, coarse.A.rows_pad), dtype=torch.float64)
    bc[0, 0] = 3.0
    yc = tdh.coarse_solve(coarse.A.row_mask, bc)
    assert float(yc[0, 0]) == pytest.approx(3.0 / a3.global_csr.data[0],
                                            rel=1e-15)
    assert float(yc[0, 1:].abs().max()) == 0.0
    b = rhs(jml, ones=True)
    x = tdh.host(tdh.vcycle(tdh.vector(np.zeros_like(b)), tdh.vector(b)))
    a = jml.levels[0].A.global_csr.to_scipy()
    assert np.isfinite(x).all()
    assert np.linalg.norm(b - a @ x) < 0.5 * np.linalg.norm(b)
