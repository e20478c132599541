"""The port's matrix files and random gallery (``gallery/io.py``,
``gallery/random.py``) against the JAX package's: ``.pm`` (both byte
orders of the PETSc header) and ``.mtx`` files written by one package and
read by the other equal bit for bit, and ``random_matrix`` /
``par_random`` draw the same matrices from the same seeds. The files are
written here: the reference's own test matrices are not in the repository.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.gallery import io as jio  # noqa: E402
from raptor_tpu.gallery import random as jrandom  # noqa: E402
from raptor_tpu_torch.gallery import dg as tdg  # noqa: E402
from raptor_tpu_torch.gallery import io as tio  # noqa: E402
from raptor_tpu_torch.gallery import random as trandom  # noqa: E402
from raptor_tpu_torch.gallery.stencils import (  # noqa: E402
    diffusion_stencil_2d, stencil_grid)

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


def _same(a, b):
    """Two CSR matrices (either package's) equal bit for bit."""
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    np.testing.assert_array_equal(np.asarray(a.indptr), np.asarray(b.indptr))
    np.testing.assert_array_equal(np.asarray(a.indices),
                                  np.asarray(b.indices))
    assert np.asarray(a.data).tobytes() == np.asarray(b.data).tobytes()


def _matrices():
    """A stencil operator, a DG operator (explicit zeros in its pattern
    kept) and a rectangular random matrix."""
    return {"aniso": stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8),
                                  (13, 11)),
            "dg": tdg.dg_diffusion(6, 5),
            "random": trandom.random_matrix(40, 29, 4, seed=3)}


@pytest.mark.parametrize("which", ["aniso", "dg", "random"])
def test_pm_round_trips_between_packages(which, tmp_path):
    a = _matrices()[which]
    tio.write_pm(tmp_path / "t.pm", a)
    jio.write_pm(tmp_path / "j.pm", a)
    assert ((tmp_path / "t.pm").read_bytes()
            == (tmp_path / "j.pm").read_bytes())
    for f in ("t.pm", "j.pm"):
        _same(tio.read_pm(tmp_path / f), a)
        _same(jio.read_pm(tmp_path / f), a)
    pa = tio.read_par_pm(tmp_path / "j.pm", 3)
    pj = jio.read_par_pm(tmp_path / "t.pm", 3)
    _same(pa.global_csr, pj.global_csr)
    np.testing.assert_array_equal(pa.partition.row_bounds,
                                  pj.partition.row_bounds)
    np.testing.assert_array_equal(pa.partition.col_bounds,
                                  pj.partition.col_bounds)


def test_pm_reads_little_endian_and_unsorted(tmp_path):
    """A little-endian file whose rows list their columns unsorted and
    twice: both packages sum the duplicates and sort, to the same bits;
    a file that is not a PETSc matrix raises."""
    rng = np.random.default_rng(5)
    n_rows, n_cols, per = 9, 7, 4
    cols = rng.integers(0, n_cols, size=n_rows * per)
    vals = rng.standard_normal(n_rows * per)
    with open(tmp_path / "le.pm", "wb") as f:
        np.array([tio.PETSC_MAT_CODE, n_rows, n_cols, n_rows * per],
                 dtype="<i4").tofile(f)
        np.full(n_rows, per, dtype="<i4").tofile(f)
        cols.astype("<i4").tofile(f)
        vals.astype("<f8").tofile(f)
    t = tio.read_pm(tmp_path / "le.pm")
    _same(t, jio.read_pm(tmp_path / "le.pm"))
    dense = np.zeros((n_rows, n_cols))
    np.add.at(dense, (np.repeat(np.arange(n_rows), per), cols), vals)
    np.testing.assert_allclose(t.to_dense(), dense, rtol=1e-15, atol=1e-15)
    (tmp_path / "bad.pm").write_bytes(np.arange(8, dtype="<i4").tobytes())
    with pytest.raises(ValueError, match="not a PETSc"):
        tio.read_pm(tmp_path / "bad.pm")


@pytest.mark.parametrize("which", ["aniso", "dg", "random"])
def test_mtx_round_trips_between_packages(which, tmp_path):
    a = _matrices()[which]
    tio.write_mm(tmp_path / "t.mtx", a)
    jio.write_mm(tmp_path / "j.mtx", a)
    for f in ("t.mtx", "j.mtx"):
        _same(tio.read_mm(tmp_path / f), jio.read_mm(tmp_path / f))
        _same(tio.read_mm(tmp_path / f), a.canonicalize())
    _same(tio.read_par_mm(tmp_path / "j.mtx", 4).global_csr,
          jio.read_par_mm(tmp_path / "t.mtx", 4).global_csr)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_gallery_matches_jax(seed):
    _same(trandom.random_matrix(50, 37, 6, seed),
          jrandom.random_matrix(50, 37, 6, seed))
    t = trandom.par_random(64, 64, 5, 4, seed)
    j = jrandom.par_random(64, 64, 5, 4, seed)
    _same(t.global_csr, j.global_csr)
    np.testing.assert_array_equal(t.partition.row_bounds,
                                  j.partition.row_bounds)
