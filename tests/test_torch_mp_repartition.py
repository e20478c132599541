"""tests/test_multiproc.py::test_multiproc_repartition_kway on the port:
the distributed repartition of an unstructured operator across 4 real
processes (``comm.multiproc.run_spmd``), where no rank ever assembles the
global matrix: each rank's labels from the label-propagation partitioner
over ``MultiProcessTransport`` equal the JAX package's in-process labels,
and its migrated rows, new row bounds and permutation equal the JAX
package's global ``make_contiguous`` on them, bit for bit. In a file of
its own because it starts real processes.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu.comm.transport import (  # noqa: E402
    InProcessTransport as JTransport)
from raptor_tpu.core.par_matrix import (  # noqa: E402
    par_matrix_from_scipy as jfrom_scipy)
from raptor_tpu.linalg import repartition as jrep  # noqa: E402
from raptor_tpu_torch.comm.multiproc import run_spmd  # noqa: E402
from raptor_tpu_torch.core.par_matrix import (  # noqa: E402
    par_matrix_from_scipy)
from raptor_tpu_torch.linalg.repartition import comm_volume  # noqa: E402

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


def _repart_worker(rank, group, blocks, part):
    """k-way-repartition the operator with no global view: the
    partitioner and the row migration both run over the transport."""
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
    from raptor_tpu_torch.linalg.repartition import (partition_graph,
                                                     repartition_matrix)
    a = ParCSRMatrix.from_local_rows([blocks[rank]], part, first_shard=rank)
    assert a.is_local_view
    tr = MultiProcessTransport(group, a)
    labels = partition_graph(a, tr=tr)
    a_new, perms = repartition_matrix(a, labels, tr=tr)
    assert a_new.is_local_view
    blk = a_new.shards()[0].global_cols_csr(a_new.global_num_cols)
    return (labels[0], blk.to_scipy(), perms[0],
            np.asarray(a_new.partition.row_bounds))


@pytest.mark.parametrize("world", [4])
def test_multiproc_repartition_kway(world):
    n = 400
    m = sp.random(n, n, density=0.02, random_state=7, format="csr")
    m = (m + m.T + sp.diags(np.ones(n) * 4)).tocsr()
    m.sort_indices()
    Ap = par_matrix_from_scipy(m, world)
    part = Ap.partition
    blocks = [blk.global_cols_csr(n) for blk in Ap.shards()]

    results = run_spmd(world, _repart_worker, blocks, part)

    # the JAX package's in-process twin and its global-path oracle
    jA = jfrom_scipy(m, world)
    labels_ip = jrep.dist_partition_graph(jA, JTransport(jA))
    proc = np.concatenate(labels_ip)
    A_ref, perm_ref = jrep.make_contiguous(jA, proc)
    rb_ref = np.asarray(A_ref.partition.row_bounds)

    got_rows = []
    for rank in range(world):
        labels_r, blk_r, perm_r, rb_r = results[rank]
        np.testing.assert_array_equal(labels_r, labels_ip[rank])
        np.testing.assert_array_equal(rb_r, rb_ref)
        np.testing.assert_array_equal(
            perm_r, perm_ref[rb_ref[rank]:rb_ref[rank + 1]])
        got_rows.append(blk_r)
    A_mp = sp.vstack(got_rows).tocsr()
    A_mp.sort_indices()
    want = A_ref.global_csr
    np.testing.assert_array_equal(A_mp.indptr, want.indptr)
    np.testing.assert_array_equal(A_mp.indices, want.indices)
    assert A_mp.data.tobytes() == want.data.tobytes()

    # the refinement must not worsen the block partition's edge cut
    block_proc = np.repeat(np.arange(world), np.diff(part.row_bounds))
    assert (comm_volume(Ap, proc)["edge_cut"]
            <= comm_volume(Ap, block_proc)["edge_cut"])
