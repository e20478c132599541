"""Distributed AMG setup in real OS processes, the twin of
examples/run_multiproc_setup.py: each rank owns only its row block
(local-view ParCSRMatrix) and the full RS pipeline runs over
MultiProcessTransport, the reference's ``mpirun -n P amg_example``
(examples/example.cpp) for the setup phase. The ranks are forked and run
host code only, as in the JAX package; the device is only checked for
(``--device``), as in every twin.

Run: python examples_torch/run_multiproc_setup.py [grid_n] [world] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.comm.multiproc import MultiProcessTransport, run_spmd
from raptor_tpu_torch.core.par_matrix import (ParCSRMatrix,
                                              par_matrix_from_scipy)
from raptor_tpu_torch.core.types import CFState
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               stencil_grid)
from raptor_tpu_torch.ruge_stuben import par_setup as ps
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights


def worker(rank, group, blocks, part, w):
    a = ParCSRMatrix.from_local_rows([blocks[rank]], part,
                                     first_shard=rank)
    tr = MultiProcessTransport(group, a)
    masks = ps.dist_classical_strength(a, 0.25, tr=tr)
    s_par = ps.strength_masks_to_par(a, masks)
    tr_s = MultiProcessTransport(group, s_par)
    states = ps.dist_split_hmis(s_par, w, tr=tr_s)
    p_blocks, n_coarse = ps.dist_extended_interpolation(
        a, s_par, states, tr=tr, assemble=False)
    sel = np.asarray(states) == CFState.Selected
    csum = np.concatenate([[0], np.cumsum(sel)])
    cb = csum[np.asarray(part.row_bounds)].astype(np.int64)
    c_blocks = ps.dist_rap(a, p_blocks, tr=tr, coarse_bounds=cb,
                           assemble=False)
    return (rank, a.local_nnz, p_blocks[0].nnz, c_blocks[0].nnz,
            n_coarse)


def main(argv=None):
    args, _ = C.parse(argv, __doc__)
    n = C.arg(args, 0, 64)
    world = C.arg(args, 1, 4)
    before = C.launches()

    A = stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n))
    Ap = par_matrix_from_scipy(A.to_scipy(), world)
    w = form_rand_weights(Ap.global_num_rows, 0)
    part = Ap.partition
    blocks = [blk.global_cols_csr(part.global_num_cols)
              for blk in Ap.shards()]

    t0 = time.perf_counter()
    results = run_spmd(world, worker, blocks, part, w)
    dt = time.perf_counter() - t0
    print(f"{world} processes, {n}x{n} aniso "
          f"(HMIS + extended+i + RAP): {dt:.2f}s")
    for rank, annz, pnnz, cnnz, nc in results:
        print(f"  rank {rank}: A block {annz} nnz -> P block {pnnz} "
              f"nnz -> Ac block {cnnz} nnz (n_coarse {nc})")
    return C.finish({"ranks": [[int(v) for v in r] for r in results]},
                    before)


if __name__ == "__main__":
    main()
