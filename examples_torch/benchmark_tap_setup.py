"""Node-aware against flat communication in the setup, the twin of
examples/benchmark_tap_setup.py (the reference's benchmark_tap_spgemm.cpp
/ profile_tap_spgemm: matrix rows staged through the 2-step
tap_mat_comm schedule, core/comm_pkg.hpp:1392-1451).

Runs the whole distributed Ruge-Stuben setup (HMIS + extended+i:
strength, splitting, interpolation and RAP, every stage exchanging rows
and halos through the transport) in real OS processes twice, flat
all-to-all and staged node by node through ``TapGroup``, and reports the
slowest rank's setup seconds, the sends that cross a node and the levels.
The ranks are forked and run host code only, as in the JAX package; the
device is only checked for (``--device``), as in every twin.

Run: python examples_torch/benchmark_tap_setup.py [grid_n] [world] [ppn] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.comm.multiproc import (MultiProcessTransport,
                                             ProcessGroup, run_spmd)
from raptor_tpu_torch.comm.spmd import spmd_rs_setup
from raptor_tpu_torch.comm.tapgroup import TapGroup
from raptor_tpu_torch.core.par_matrix import (ParCSRMatrix,
                                              par_matrix_from_scipy)
from raptor_tpu_torch.core.types import CoarsenType, InterpType
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               stencil_grid)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights


class CountingGroup(ProcessGroup):
    """A rank's process group that counts its sends to another node
    (``ppn`` ranks a node)."""

    def __init__(self, rank, world, inboxes, ppn):
        super().__init__(rank, world, inboxes)
        self.ppn = ppn
        self.inter_sends = 0

    def send(self, dst, tag, payload):
        if dst // self.ppn != self.rank // self.ppn and dst != self.rank:
            self.inter_sends += 1
        super().send(dst, tag, payload)


def worker(rank, group_raw, blocks, part, w, ppn, tap):
    base = CountingGroup(group_raw.rank, group_raw.world,
                         group_raw.inboxes, ppn)
    group = TapGroup(base, ppn) if tap else base
    a = ParCSRMatrix.from_local_rows([blocks[rank]], part,
                                     first_shard=rank)
    t0 = time.perf_counter()
    h = spmd_rs_setup(a, w, lambda m: MultiProcessTransport(group, m),
                      coarsen=CoarsenType.HMIS,
                      interp=InterpType.Extended)
    return time.perf_counter() - t0, base.inter_sends, h.num_levels


def main(argv=None):
    args, _ = C.parse(argv, __doc__)
    n = C.arg(args, 0, 48)
    world = C.arg(args, 1, 4)
    ppn = C.arg(args, 2, 2)
    before = C.launches()

    A = stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n))
    Ap = par_matrix_from_scipy(A.to_scipy(), world)
    w = form_rand_weights(Ap.global_num_rows, 0)
    part = Ap.partition
    blocks = [blk.global_cols_csr(part.global_num_cols)
              for blk in Ap.shards()]

    out = {}
    for tap in (False, True):
        res = run_spmd(world, worker, blocks, part, w, ppn, tap)
        label = "TAP (2-step)" if tap else "flat"
        setup_s = max(r[0] for r in res)
        sends = sum(r[1] for r in res)
        print(f"{label:>13}: setup max {setup_s:.2f}s, "
              f"inter-node sends {sends}, {res[0][2]} levels "
              f"({world} procs = {world // ppn} nodes x {ppn} PPN)")
        out["tap" if tap else "flat"] = {
            "setup_s": setup_s, "inter_node_sends": int(sends),
            "levels": int(res[0][2])}
    return C.finish(out, before)


if __name__ == "__main__":
    main()
