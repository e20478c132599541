"""The port's ``core/topology.py`` against the JAX package's: the shard ->
slot maps of the three rank orderings, the ``PPN`` and
``RAPTOR_RANK_REORDER_METHOD`` overrides, and ``reorder_shards`` giving
the JAX package's matrices and permutations (tests/test_aux.py:76-118),
with the TAP comm model's bytes across hosts ordered as there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.core import topology as jtopo  # noqa: E402
from raptor_tpu_torch.comm.tap import build_tap_plan  # noqa: E402
from raptor_tpu_torch.core import topology as ttopo  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.profiling.comm_model import (  # noqa: E402
    model_tap_plan)

from _torch_parity import _one_intra_op_thread, aniso, to_port  # noqa: E402,F401,E501


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("n_procs,ppn", [(8, 4), (8, 2), (6, 4), (16, 16)])
def test_topology_slots_match_jax(method, n_procs, ppn, monkeypatch):
    monkeypatch.delenv(ttopo.ENV_METHOD, raising=False)
    monkeypatch.delenv(ttopo.ENV_PPN, raising=False)
    t = ttopo.Topology(n_procs, ppn=ppn, rank_ordering=method)
    j = jtopo.Topology(n_procs, ppn=ppn, rank_ordering=method)
    assert (t.ppn, t.rank_ordering, t.num_nodes) == (j.ppn, j.rank_ordering,
                                                    j.num_nodes)
    for p in range(n_procs):
        assert t.get_node(p) == j.get_node(p)
        assert t.get_local_proc(p) == j.get_local_proc(p)
    np.testing.assert_array_equal(t.shard_slots(), j.shard_slots())
    if n_procs % ppn == 0:
        assert sorted(t.shard_slots()) == list(range(n_procs))
    if method == 1:
        np.testing.assert_array_equal(t.shard_slots(), np.arange(n_procs))


def test_topology_env_override(monkeypatch):
    monkeypatch.setenv(ttopo.ENV_METHOD, "0")
    monkeypatch.setenv(ttopo.ENV_PPN, "2")
    assert (ttopo.ENV_METHOD, ttopo.ENV_PPN) == (jtopo.ENV_METHOD,
                                                 jtopo.ENV_PPN)
    t = ttopo.Topology(8, ppn=16, rank_ordering=1)
    j = jtopo.Topology(8, ppn=16, rank_ordering=1)
    assert t.rank_ordering == 0 and t.ppn == 2 and t.num_nodes == 4
    # method 0: node = proc % nodes, local = proc // nodes
    assert [t.get_node(p) for p in range(8)] == [0, 1, 2, 3, 0, 1, 2, 3]
    assert [t.get_local_proc(p) for p in range(8)] == [0, 0, 0, 0,
                                                       1, 1, 1, 1]
    np.testing.assert_array_equal(t.shard_slots(), j.shard_slots())
    monkeypatch.setenv(ttopo.ENV_METHOD, "3")
    with pytest.raises(ValueError, match="not supported"):
        ttopo.Topology(8)


@pytest.mark.parametrize("problem", ["aniso", "dg"])
def test_reorder_shards_matches_jax(problem, monkeypatch):
    """Each ordering moves row block s to slot s exactly as the JAX
    package does: the same permutation and the same matrix, bit for bit,
    an exact symmetric permutation of A; blocked placement (1) pays no
    more bytes across hosts than the round-robin ones on the 2-D
    operator (tests/test_aux.py:76)."""
    monkeypatch.delenv(ttopo.ENV_METHOD, raising=False)
    monkeypatch.delenv(ttopo.ENV_PPN, raising=False)
    if problem == "aniso":
        j = aniso(24, 8)
        t = to_port(j)
    else:
        from raptor_tpu.gallery.fem import par_fem as jpar_fem
        j, t = jpar_fem("dg_diffusion", 10, 8, 8), par_fem("dg_diffusion",
                                                          10, 8, 8)
    dcn = {}
    for method in (0, 1, 2):
        tn, tperm = ttopo.reorder_shards(t, ttopo.Topology(8, 4, method))
        jn, jperm = jtopo.reorder_shards(j, jtopo.Topology(8, 4, method))
        np.testing.assert_array_equal(tperm, jperm)
        tg, jg = tn.global_csr, jn.global_csr
        np.testing.assert_array_equal(tg.indptr, jg.indptr)
        np.testing.assert_array_equal(tg.indices, jg.indices)
        assert tg.data.tobytes() == jg.data.tobytes()
        np.testing.assert_array_equal(tn.partition.row_bounds,
                                      jn.partition.row_bounds)
        ref = t.global_csr.to_scipy()[tperm][:, tperm].tocsr()
        assert abs(ref - tg.to_scipy()).max() == 0.0
        dcn[method] = model_tap_plan(
            build_tap_plan(tn, 2, 4)).inter_host_bytes
    if problem == "aniso":
        assert dcn[1] <= dcn[0] and dcn[1] <= dcn[2] and dcn[0] > 0


def test_reorder_shards_refuses_a_non_permutation(monkeypatch):
    monkeypatch.delenv(ttopo.ENV_PPN, raising=False)
    monkeypatch.delenv(ttopo.ENV_METHOD, raising=False)
    t = to_port(aniso(12, 6))
    with pytest.raises(ValueError, match="permutation"):
        ttopo.reorder_shards(t, ttopo.Topology(6, 4, 0))
