"""Parity of the port's smoothed-aggregation stages with the JAX package's,
stage by stage: symmetric strength, the MIS(2) states, aggregation with and
without tie-break weights, the tentative prolongator from one and from two
candidates (T and the coarse candidates R), and Jacobi prolongation with
one and two smoothing steps.

Each stage runs in both packages on the same inputs: every level's A of the
JAX package's SA hierarchy, and JAX's outputs of the stages before it. The
problems are the 25^2 rotated anisotropic diffusion at 4 shards (theta
0.25) and the 16^3 and 64^3 27-point Laplacians (theta 0); weights come from
``form_rand_weights``, candidates from a numpy seed. Both packages bind the
repository's csrc/setup_kernels.cpp with the same flags and make the same
numpy / scipy calls in the same order, so every array is held bit-equal.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.aggregation import aggregate as jagg  # noqa: E402
from raptor_tpu.aggregation import candidates as jcand  # noqa: E402
from raptor_tpu.aggregation import mis as jmis  # noqa: E402
from raptor_tpu.aggregation import prolongation as jprol  # noqa: E402
from raptor_tpu.core.types import StrengthType as JStrength  # noqa: E402
from raptor_tpu.ruge_stuben import strength as jstr  # noqa: E402
from raptor_tpu.utils import glibc_rand as jrand  # noqa: E402
from raptor_tpu_torch.aggregation import aggregate as tagg  # noqa: E402
from raptor_tpu_torch.aggregation import candidates as tcand  # noqa: E402
from raptor_tpu_torch.aggregation import mis as tmis  # noqa: E402
from raptor_tpu_torch.aggregation import prolongation as tprol  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix as TCSR  # noqa: E402
from raptor_tpu_torch.core.types import StrengthType  # noqa: E402
from raptor_tpu_torch.ruge_stuben import strength as tstr  # noqa: E402

from _torch_parity import SA_PROBLEMS, jax_sa, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

PROBLEMS = ["aniso25", "lap16", "lap64"]
STAGES = ["strength", "mis2", "aggregate", "aggregate_rand", "candidates1",
          "candidates2", "jacobi1", "jacobi2"]


def _port_csr(m):
    """A JAX-package CSRMatrix as the port's, on copies of its arrays."""
    return TCSR(m.n_rows, m.n_cols, m.indptr.copy(), m.indices.copy(),
                np.asarray(m.data, np.float64).copy())


def _same_csr(t, j):
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.data.tobytes() == np.asarray(j.data, np.float64).tobytes()


def _same_bits(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape
    assert t.tobytes() == j.tobytes()


@functools.lru_cache(maxsize=None)
def _jax_chain(problem):
    """Per level of JAX's hierarchy: the inputs every stage takes, from the
    JAX package's stages (A, S, weights, states, aggregates, the one- and
    two-candidate blocks, T)."""
    theta = SA_PROBLEMS[problem][2]
    jml = jax_sa(problem)
    weights = jrand.form_rand_weights(jml.levels[0].A.global_num_rows, 0)
    rng = np.random.default_rng(5)
    out = []
    for lvl in jml.levels[:-1]:
        a = lvl.A.global_csr
        n = a.n_rows
        w = weights[:n]
        s = jstr.strength(a, JStrength.Symmetric, theta)
        states = jmis.mis2(s, w)
        n_aggs, aggs = jagg.aggregate(a, s, states)
        b1 = rng.random(n) + 0.5
        b2 = np.concatenate([np.ones(n), rng.standard_normal(n)])
        t, _ = jcand.fit_candidates(n_aggs, aggs, b1)
        out.append(dict(a=a, s=s, w=w, theta=theta, states=states,
                        n_aggs=n_aggs, aggs=aggs, b1=b1, b2=b2, t=t))
    return out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_sa_stage_bit_equal_to_jax(problem, stage):
    levels = _jax_chain(problem)
    assert len(levels) >= 2
    for c in levels:
        a, s = c["a"], c["s"]
        ta, ts = _port_csr(a), _port_csr(s)
        if stage == "strength":
            _same_csr(tstr.strength(ta, StrengthType.Symmetric, c["theta"]),
                      s)
        elif stage == "mis2":
            got = tmis.mis2(ts, c["w"])
            _same_bits(got, c["states"])
            assert set(np.unique(got)) <= {0, 1} and got.any()
        elif stage in ("aggregate", "aggregate_rand"):
            r = c["w"] if stage == "aggregate_rand" else None
            want = jagg.aggregate(a, s, c["states"], r)
            got = tagg.aggregate(ta, ts, c["states"], r)
            assert got[0] == want[0] == int((c["states"] > 0).sum())
            _same_bits(got[1], want[1])
            assert got[1].min() >= 0 and got[1].max() < got[0]
        elif stage == "candidates1":
            jt, jr = jcand.fit_candidates(c["n_aggs"], c["aggs"], c["b1"])
            tt, tr = tcand.fit_candidates(c["n_aggs"], c["aggs"], c["b1"])
            _same_csr(tt, jt)
            _same_bits(tr, jr)
        elif stage == "candidates2":
            jt, jr = jcand.fit_candidates(c["n_aggs"], c["aggs"], c["b2"], 2)
            tt, tr = tcand.fit_candidates(c["n_aggs"], c["aggs"], c["b2"], 2)
            assert tt.n_cols == 2 * c["n_aggs"]
            _same_csr(tt, jt)
            _same_bits(tr, jr)
        else:
            steps = int(stage[-1])
            want = jprol.jacobi_prolongation(a, c["t"], 4.0 / 3.0, steps)
            got = tprol.jacobi_prolongation(ta, _port_csr(c["t"]),
                                            4.0 / 3.0, steps)
            _same_csr(got, want)


def test_strength_dispatch_keeps_partition():
    """``strength`` on a ParCSRMatrix dispatches on the strength type and
    keeps the partition."""
    jA = jax_sa("aniso25").levels[0].A
    tA = to_port(jA)
    for st, jst in ((StrengthType.Classical, JStrength.Classical),
                    (StrengthType.Symmetric, JStrength.Symmetric)):
        got = tstr.strength(tA, st, 0.25)
        assert got.partition is tA.partition
        _same_csr(got.global_csr, jstr.strength(jA, jst, 0.25).global_csr)


def test_native_outputs_are_checked():
    """The bindings refuse an output array the C code could not write in
    place, and a weight vector shorter than the matrix."""
    from raptor_tpu_torch import native
    s = _jax_chain("lap16")[0]["s"].to_scipy()
    csc = s.tocsc()
    n = s.shape[0]
    r = np.zeros(n)
    with pytest.raises(ValueError, match="states"):
        native.mis2(s.indptr, s.indices, csc.indptr, csc.indices, r,
                    np.zeros(n, dtype=np.int32))
    with pytest.raises(ValueError, match="weights"):
        native.mis2(s.indptr, s.indices, csc.indptr, csc.indices, r[:-1],
                    np.zeros(n, dtype=np.int64))
    with pytest.raises(ValueError, match="aggregates"):
        native.aggregate(s.indptr, s.indices, s.indptr, s.indices, s.data,
                         np.ones(n), r, np.zeros(n - 1, dtype=np.int64))
