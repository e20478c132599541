"""Parity of the port's host setup with the JAX package's: the same
stencil matrices, weights, strength, CF splittings, prolongators and
Galerkin operators level by level (both bind the repository's
csrc/setup_kernels.cpp with the same flags, so the hierarchies agree bit
for bit), and the port's import and device rules."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.ruge_stuben import cf_splitting as jcf  # noqa: E402
from raptor_tpu.ruge_stuben import strength as jstr  # noqa: E402
from raptor_tpu.utils import glibc_rand as jrand  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.ruge_stuben import cf_splitting as tcf  # noqa: E402
from raptor_tpu_torch.ruge_stuben import strength as tstr  # noqa: E402
from raptor_tpu_torch.utils import glibc_rand as trand  # noqa: E402

from _torch_parity import (  # noqa: E402
    ANISO, assert_same_matrix, jax_hierarchy, to_port)

CASES = [(32, 1), (64, 1), (64, 4), (48, 8)]


def _port_setup(n, S, sweeps=3):
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = sweeps
    ml.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO),
                                  (n, n), S))
    return ml


@pytest.mark.parametrize("stencil", ["aniso", "laplace27"])
def test_stencils_match(stencil):
    if stencil == "aniso":
        jm = jst.stencil_grid(jst.diffusion_stencil_2d(*ANISO), (20, 17))
        tm = tst.stencil_grid(tst.diffusion_stencil_2d(*ANISO), (20, 17))
    else:
        jm = jst.stencil_grid(jst.laplace_stencil_27pt(), (6, 5, 4))
        tm = tst.stencil_grid(tst.laplace_stencil_27pt(), (6, 5, 4))
    for f in ("indptr", "indices", "data"):
        assert getattr(tm, f).tobytes() == getattr(jm, f).tobytes()


def test_rand_weights_match():
    np.testing.assert_array_equal(trand.form_rand_weights(1000, 7),
                                  jrand.form_rand_weights(1000, 7))


@pytest.mark.parametrize("n,S", CASES)
def test_hierarchy_matches_jax(n, S):
    """Level count, sizes, nnz, A and P of every level, and the coarse LU."""
    jml = jax_hierarchy(n, S)
    tml = _port_setup(n, S)
    assert tml.num_levels == len(jml.levels)
    for tl, jl in zip(tml.levels, jml.levels):
        assert tl.A.global_num_rows == jl.A.global_num_rows
        assert tl.A.nnz == jl.A.nnz
        assert_same_matrix(tl.A, jl.A)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            assert_same_matrix(tl.P, jl.P)
    np.testing.assert_allclose(tml.coarse_lu[0], jml.coarse_lu[0],
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(tml.coarse_lu[1], jml.coarse_lu[1])


@pytest.mark.parametrize("n,S", CASES)
def test_strength_and_splitting_match_jax(n, S):
    """Strength and CF states on every level's operator, with the RS-then-
    Falgout rule of the flagship setup."""
    jml = jax_hierarchy(n, S)
    weights = jrand.form_rand_weights(jml.levels[0].A.global_num_rows, 0)
    for i, jl in enumerate(jml.levels[:-1]):
        tA = to_port(jl.A)
        js = jstr.strength(jl.A, theta=0.25)
        ts = tstr.strength(tA, theta=0.25)
        assert_same_matrix(ts, js)
        if i < 3:
            jst_, tst_ = jcf.split_rs_entry(js), tcf.split_rs_entry(ts)
        else:
            w = weights[:jl.A.global_num_rows]
            jst_, tst_ = jcf.split_falgout(js, w), tcf.split_falgout(ts, w)
        np.testing.assert_array_equal(tst_, jst_)


def test_unported_options_raise():
    """Options of the reference that the port does not run yet raise."""
    from raptor_tpu_torch.core.types import StrengthType
    for ct in (CoarsenType.CLJP, CoarsenType.Falgout):
        with pytest.raises(NotImplementedError, match="CLJP and Falgout"):
            ParRugeStubenSolver(0.25, ct, InterpType.Extended)
    with pytest.raises(NotImplementedError, match="direct"):
        ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Direct)
    with pytest.raises(NotImplementedError, match="classical strength"):
        ParRugeStubenSolver(0.25, CoarsenType.HMIS, InterpType.Extended,
                            StrengthType.Symmetric)


def test_port_imports_neither_jax_nor_raptor_tpu():
    """Importing the port and every submodule loads no jax module and
    nothing of raptor_tpu."""
    code = r"""
import importlib, pkgutil, sys
import raptor_tpu_torch
for m in pkgutil.walk_packages(raptor_tpu_torch.__path__, "raptor_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "raptor_tpu" or k.startswith("raptor_tpu."))
assert not bad, bad
print(len([k for k in sys.modules if k.startswith("raptor_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=300)
    assert int(out.stdout.strip()) >= 20


def test_default_device_raises_without_cuda(monkeypatch):
    """The device entry points default to CUDA and raise without it; they
    never drop to the CPU on their own."""
    from raptor_tpu_torch.device import par as tpar
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tml = _port_setup(32, 1)
    a = tml.levels[0].A
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.device_put_matrix(a)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.device_put_vector(np.ones(a.global_num_rows),
                               a.partition.row_bounds, 1024)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceHierarchy(tml)
