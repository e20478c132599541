"""Parity of the Krylov twins in ``examples_torch/`` (CG against AMG-PCG,
the PCG time split, GMRES against AMG-GMRES) with the JAX package's
scripts in ``examples/``, run as ``test_torch_examples_basic.py`` runs
them: iteration counts equal, float64 histories equal to rtol 1e-6.
Times are not compared."""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_examples import grab, run_jax, run_twin, same_history
from _torch_parity import _one_intra_op_thread  # noqa: F401


# plain CG's first iterations, whose residuals are held to 1e-6: along
# 100-150 unpreconditioned iterations the rounding of a reordered sum grows
# until the histories part (JAX's own at 1 and 4 shards part there too,
# test_torch_krylov.py), and the count may end one apart
CG_HELD = 50


@pytest.mark.parametrize("args", [(32, 4, "f64"), (24, 8, "f64")])
def test_benchmark_pcg(args):
    """Plain CG and AMG-PCG (Chebyshev(3) hierarchy) to 1e-8 in float64:
    AMG-PCG's iterations equal and its history to 1e-6; plain CG's count
    within one, its first CG_HELD residuals to 1e-6."""
    out, rec = run_jax("benchmark_pcg.py", *args)
    tout, got = run_twin("benchmark_pcg", *args)
    (cg_jax,) = grab(r"^CG    : +(\d+) iters", out)
    assert abs(got["cg_iterations"] - cg_jax) <= 1
    assert grab(r"^AMG-PCG: +(\d+) iters", out) == [got["pcg_iterations"]]
    cg_runs = [r for r in rec if r["fn"] == "cg"]
    assert len(cg_runs) == 4       # each solve twice (compile, then timed)
    plain, pcg = cg_runs[1], cg_runs[3]
    assert plain["n_iters"] == cg_jax > CG_HELD
    same_history(got["cg_residuals"][:CG_HELD], plain["res"][:CG_HELD])
    same_history(got["pcg_residuals"], pcg["res"])


def test_profile_pcg():
    """The float32 AMG-PCG after the time split: its iterations to 1e-5
    equal; the split's four parts printed, each a positive time."""
    args = (24, 4)
    out, rec = run_jax("profile_pcg.py", *args)
    tout, got = run_twin("profile_pcg", *args)
    assert grab(r"^PCG: (\d+) iters", out) == [got["pcg_iterations"]]
    assert rec[-1]["n_iters"] == got["pcg_iterations"] > 1
    keys = grab(r"^  (\w+_t) ", out, str)
    assert grab(r"^  (\w+_t) ", tout, str) == keys == [
        "total_t", "precond_t", "spmv_t", "comm_t"]
    assert all(got["split_s"][k] > 0 for k in keys)
    assert tout.splitlines()[0] == out.splitlines()[0]


@pytest.mark.parametrize("args", [(32, 4, 10), (24, 8, 30)])
def test_benchmark_gmres(args):
    """GMRES(m) and AMG-GMRES (CLJP + modified classical + SOR) on the
    convection-diffusion operator to 1e-8: each one's iterations equal,
    both histories to 1e-6, the host-recomputed residual to 1e-6. The
    script leaves JAX's 64-bit mode off, where its float32 cannot reach
    1e-8 and the count is the rounding's; it runs with the mode on, as
    the float64 twin does."""
    out, rec = run_jax("benchmark_gmres.py", *args, x64=True)
    tout, got = run_twin("benchmark_gmres", *args)
    plain = [r for r in rec if r["fn"] == "gmres"][1]
    pre = [r for r in rec if r["fn"] == "gmres"][3]
    assert grab(r"^GMRES\(\d+\): (\d+) iters", out) == [
        got["gmres_iterations"]] == [plain["n_iters"]]
    assert grab(r"^AMG-GMRES: (\d+) iters", out) == [
        got["amg_gmres_iterations"]] == [pre["n_iters"]]
    same_history(got["gmres_residuals"], plain["res"])
    same_history(got["amg_gmres_residuals"], pre["res"])
    np.testing.assert_allclose(
        got["true_residual"], grab(r"^true rel resid: (\S+)", out, float),
        rtol=1e-6)
