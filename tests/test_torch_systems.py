"""Unknown-based (systems) AMG in the port against the JAX package: classical
strength and modified-classical / extended+i interpolation restricted to
same-variable couplings, on the host kernels and the device engines (CPU
tensors), and whole ``num_variables = 2`` hierarchies on Q1 elasticity,
global (1 and 4 shards) and ``setup_mode = "distributed"`` (4 shards, whose
interpolations take no variables in either package), bit for bit with the
variable ids each level keeps. The solves are in
tests/test_torch_systems_solve.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu.core.matrix import CSRMatrix as JCSR  # noqa: E402
from raptor_tpu.core.types import (  # noqa: E402
    CoarsenType as JC, InterpType as JI, RelaxType as JR,
    StrengthType as JS)
from raptor_tpu.gallery.fem import par_fem as jfem  # noqa: E402
from raptor_tpu.gallery.stencils import (  # noqa: E402
    diffusion_stencil_2d, stencil_grid)
from raptor_tpu.multilevel import par_multilevel as jpm  # noqa: E402
from raptor_tpu.ruge_stuben import cf_splitting as jcf  # noqa: E402
from raptor_tpu.ruge_stuben import interpolation as jint  # noqa: E402
from raptor_tpu.ruge_stuben import par_setup as jps  # noqa: E402
from raptor_tpu.ruge_stuben.strength import strength as jstrength  # noqa
from raptor_tpu_torch.core.matrix import CSRMatrix as TCSR  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType, StrengthType)
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.ruge_stuben import interpolation as tint  # noqa: E402
from raptor_tpu_torch.ruge_stuben.strength import strength  # noqa: E402

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


def _interleaved():
    """tests/test_checkpoint.py:36's two-variable system: the 10 x 10
    Laplacian with the variables interleaved and weakly coupled."""
    lap = stencil_grid(diffusion_stencil_2d(1.0, 0.0), (10, 10)).to_scipy()
    n = lap.shape[0]
    a = sp.kron(lap, sp.eye(2)).tocsr()
    a = (a + sp.kron(sp.eye(n), sp.csr_matrix([[0, 0.01], [0.01, 0]])))
    return JCSR.from_scipy(a.tocsr()), np.tile([0, 1], n).astype(np.int64)


def _elasticity():
    a, variables = jfem("elasticity", 24, 24, 1)
    return a.global_csr, variables


MATRICES = {"interleaved10": _interleaved, "elasticity24": _elasticity}


def _port(m) -> TCSR:
    return TCSR(m.n_rows, m.n_cols, m.indptr.copy(), m.indices.copy(),
                np.asarray(m.data, np.float64).copy())


def _bytes_equal(t, j):
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for f in ("indptr", "indices", "data"):
        assert getattr(t, f).tobytes() == getattr(j, f).tobytes(), f


def _inputs(name):
    """(JAX A, its systems S, the port's A and S, CF states of JAX's RS
    splitting, variables)."""
    a, variables = MATRICES[name]()
    s = jstrength(a, JS.Classical, 0.25, 2, variables)
    states = np.asarray(jcf.split_rs_entry(s), dtype=np.int64)
    return a, s, _port(a), _port(s), states, variables


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_strength_with_variables_matches_jax(name):
    a, variables = MATRICES[name]()
    ta = _port(a)
    got = strength(ta, StrengthType.Classical, 0.25, 2, variables)
    _bytes_equal(got, jstrength(a, JS.Classical, 0.25, 2, variables))
    # no cross-variable off-diagonal is strong, and the variables matter
    rows = np.repeat(np.arange(got.n_rows), np.diff(got.indptr))
    off = rows != got.indices
    assert np.all(variables[rows[off]] == variables[got.indices[off]])
    scalar = strength(ta, StrengthType.Classical, 0.25)
    # (the interleaved system's cross couplings are positive: never
    # strong, with or without the ids)
    assert scalar.nnz > got.nnz or name == "interleaved10"
    # one variable: the ids are ignored, as in the JAX package
    _bytes_equal(strength(ta, StrengthType.Classical, 0.25, 1, variables),
                 scalar)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("kind", ["mod_classical", "extended"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_interpolation_with_variables_matches_jax(name, kind, engine):
    """Host kernels bit for bit; the device modified classical (CPU
    tensors) in JAX's pattern, its values to 1e-14 of max |P|; the device
    extended+i, single-variable in both packages, hands the level to the
    host kernel and says why."""
    a, s, ta, ts, states, variables = _inputs(name)
    ref = (jint.mod_classical_interpolation if kind == "mod_classical"
           else jint.extended_interpolation)(a, s, states, 2, variables)
    got = tint._DISPATCH[kind](ta, ts, states, engine, ta.nnz, "cpu", 2,
                               variables)
    if engine == "device" and kind == "mod_classical":
        assert tint.LAST_ENGINE["interp"] == "device"
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.data, ref.data, rtol=0,
                                   atol=1e-14 * np.abs(ref.data).max())
    else:
        assert tint.LAST_ENGINE["interp"] == "host"
        assert ("single-variable" in tint.LAST_ENGINE["reason"]) == (
            engine == "device")
        _bytes_equal(got, ref)
    # the variables change P
    scalar = (jint.mod_classical_interpolation if kind == "mod_classical"
              else jint.extended_interpolation)(a, s, states)
    assert not (np.array_equal(scalar.indices, ref.indices)
                and np.array_equal(scalar.data, ref.data))


def _setups(n_shards, mode, monkeypatch):
    """(port, JAX) CLJP + modified classical + SOR systems hierarchies of
    24 x 24 elasticity, and the variables JAX's strength received level
    by level (JAX keeps only the last level's on the solver)."""
    seen = []
    if mode == "global":
        def spy(a, st, theta, num_variables, variables):
            seen.append(variables)
            return jstrength(a, st, theta, num_variables, variables)
        monkeypatch.setattr(jpm, "strength", spy)
    else:
        real = jps.dist_classical_strength

        def spy(a, theta, num_variables, variables):
            seen.append(variables)
            return real(a, theta, num_variables, variables)
        monkeypatch.setattr(jps, "dist_classical_strength", spy)
    jA, jv = jfem("elasticity", 24, 24, n_shards)
    jml = jpm.ParRugeStubenSolver(0.25, JC.CLJP, JI.ModClassical,
                                  relax_type=JR.SOR)
    tA, tv = par_fem("elasticity", 24, 24, n_shards)
    tml = ParRugeStubenSolver(0.25, CoarsenType.CLJP,
                              InterpType.ModClassical,
                              relax_type=RelaxType.SOR)
    for ml, v in ((jml, jv), (tml, tv)):
        ml.num_variables = 2
        ml.variables = v
        ml.rap_mode = ml.interp_mode = "host"
        ml.setup_mode = mode
    jml.setup(jA)
    tml.setup(tA)
    return tml, jml, seen


@pytest.mark.parametrize("n_shards,mode", [(1, "global"), (4, "global"),
                                           (4, "distributed")])
def test_elasticity_systems_hierarchy_matches_jax(n_shards, mode,
                                                  monkeypatch):
    tml, jml, seen = _setups(n_shards, mode, monkeypatch)
    assert tml.num_levels == jml.num_levels > 3
    for tl, jl in zip(tml.levels, jml.levels):
        _bytes_equal(tl.A.global_csr, jl.A.global_csr)
        np.testing.assert_array_equal(tl.A.partition.row_bounds,
                                      jl.A.partition.row_bounds)
        if jl.P is not None:
            _bytes_equal(tl.P.global_csr, jl.P.global_csr)
    # every level but the coarsest was extended with its rows' ids
    assert len(seen) == tml.num_levels - 1
    for tl, v in zip(tml.levels, seen):
        np.testing.assert_array_equal(tl.variables, v)
    np.testing.assert_array_equal(tml.levels[-1].variables, jml.variables)
    assert tml.variables is tml.levels[0].variables


def test_systems_variables_must_fit_the_matrix():
    tA, tv = par_fem("elasticity", 6, 4, 1)
    ml = ParRugeStubenSolver(0.25)
    ml.num_variables = 2
    with pytest.raises(ValueError, match="variables"):
        ml.setup(tA)
    ml.variables = tv[:-1]
    with pytest.raises(ValueError, match="variables"):
        ml.setup(tA)
    assert ml.levels == []
