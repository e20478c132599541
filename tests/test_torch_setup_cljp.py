"""Parity of the port's host setup with the JAX package's under the
coarsenings and the interpolation the reference's example runs use: CLJP
and Falgout as the coarsening, direct interpolation
(examples/example.py, examples/benchmark_solve.py). Both packages bind the
repository's csrc/setup_kernels.cpp with the same flags, so the
hierarchies agree bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.ruge_stuben import cf_splitting as jcf  # noqa: E402
from raptor_tpu.ruge_stuben import interpolation as jinterp  # noqa: E402
from raptor_tpu.ruge_stuben import strength as jstr  # noqa: E402
from raptor_tpu.utils import glibc_rand as jrand  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.ruge_stuben import cf_splitting as tcf  # noqa: E402
from raptor_tpu_torch.ruge_stuben import interpolation as tinterp  # noqa: E402
from raptor_tpu_torch.ruge_stuben import strength as tstr  # noqa: E402

from _torch_parity import ANISO, jax_rs, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

CONFIGS = [("CLJP", "ModClassical"), ("Falgout", "ModClassical"),
           ("RS", "Direct"), ("CLJP", "Direct")]


def _same_bits(t, j):
    """A port ParCSRMatrix bit-equal to a JAX-package one."""
    for f in ("row_bounds", "col_bounds"):
        np.testing.assert_array_equal(getattr(t.partition, f),
                                      getattr(j.partition, f))
    tg, jg = t.global_csr, j.global_csr
    assert tg.shape == jg.shape
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert tg.data.tobytes() == np.asarray(jg.data, np.float64).tobytes()


@pytest.mark.parametrize("coarsen,interp", CONFIGS)
@pytest.mark.parametrize("n,S", [(40, 1), (40, 4), (57, 1), (57, 4)])
def test_hierarchy_bit_equal_to_jax(coarsen, interp, n, S):
    """Level count, every A and P and the coarse LU, bit for bit."""
    jml = jax_rs(n, S, coarsen, interp)
    tml = ParRugeStubenSolver(0.25, getattr(CoarsenType, coarsen),
                              getattr(InterpType, interp),
                              relax_type=RelaxType.SOR)
    tml.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (n, n),
                                   S))
    assert tml.num_levels == jml.num_levels > 2
    for tl, jl in zip(tml.levels, jml.levels):
        _same_bits(tl.A, jl.A)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            _same_bits(tl.P, jl.P)
    for t, j in zip(tml.coarse_lu, jml.coarse_lu):
        assert np.asarray(t).tobytes() == np.asarray(j).tobytes()


@pytest.mark.parametrize("S", [1, 4])
def test_cljp_states_and_direct_p_match_jax(S):
    """``split_cljp`` and ``direct_interpolation`` entry by entry on every
    level's operator of the CLJP hierarchy, with their own weights."""
    jml = jax_rs(40, S, "CLJP", "Direct")
    weights = jrand.form_rand_weights(jml.levels[0].A.global_num_rows, 0)
    for jl in jml.levels[:-1]:
        w = weights[:jl.A.global_num_rows]
        js = jstr.strength(jl.A, theta=0.25)
        ts = tstr.strength(to_port(jl.A), theta=0.25)
        jst_, tst_ = jcf.split_cljp(js, w), tcf.split_cljp(ts, w)
        np.testing.assert_array_equal(tst_, jst_)
        t = tinterp.direct_interpolation(to_port(jl.A).global_csr,
                                         ts.global_csr, tst_)
        j = jinterp.direct_interpolation(jl.A.global_csr, js.global_csr,
                                         jst_)
        assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
