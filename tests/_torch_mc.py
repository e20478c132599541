"""Workers of the port's multi-process tests (tests/test_torch_netgroup.py,
tests/test_torch_multicontroller.py, tests/test_torch_spmd.py), beside
``_torch_parity``.

The controller functions (``bridge``, ``group_ops``, ``fails``,
``sleeps``) run in interpreters that ``raptor_tpu_torch.comm.launch``
starts, one per controller: they import the port only, never JAX.
``transport_ops`` also runs under the fork launcher ``run_spmd`` and
``run_threads`` below runs a rank function in threads of this process.
"""

import queue
import threading
import time

import numpy as np

ANISO = (0.001, np.pi / 8)


def run_threads(world, fn, *args, timeout=120.0):
    """``fn(rank, group, *args)`` for every rank in a thread of this
    process over a ``ProcessGroup`` of in-memory queues; every rank's
    result, in rank order. Torch ops are safe here, unlike in a fork."""
    from raptor_tpu_torch.comm.multiproc import ProcessGroup
    inboxes = [queue.Queue() for _ in range(world)]
    results, errors = [None] * world, []

    def run(rank):
        try:
            results[rank] = fn(rank, ProcessGroup(rank, world, inboxes),
                               *args)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0][1]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"ranks still running after {timeout} s")
    return results


def aniso_view(n, world, rank):
    """This rank's local view of the n x n anisotropic problem, built from
    its own rows only, and those rows (global columns)."""
    from raptor_tpu_torch.comm.transport import split_rows
    from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
    from raptor_tpu_torch.core.partition import Partition
    from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                                   stencil_grid)
    A = stencil_grid(diffusion_stencil_2d(*ANISO), (n, n))
    part = Partition.create(n * n, n * n, world)
    block = split_rows(A, part.row_bounds)[rank]
    return ParCSRMatrix.from_local_rows([block], part,
                                        first_shard=rank), block


def transport_ops(rank, group, blocks, part):
    """Every ``MultiProcessTransport`` primitive on rank ``rank``'s view of
    ``blocks`` (row blocks with global columns), with seeded inputs."""
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
    a = ParCSRMatrix.from_local_rows([blocks[rank]], part, first_shard=rank)
    tr = MultiProcessTransport(group, a)
    rng = np.random.default_rng(rank)
    blk = a.shards()[0]
    n_loc = blk.local_num_rows
    n = part.global_num_rows
    local = rng.standard_normal(n_loc)
    halo = rng.standard_normal(len(blk.off_proc_column_map))
    ids = rng.integers(0, n, 7)
    rows = rng.integers(0, n, 5)
    r0 = int(part.row_bounds[rank])
    trip = (rng.integers(0, n, 9), rng.integers(0, n, 9),
            rng.standard_normal(9))
    return {
        "fetch": tr.fetch([local])[0],
        "reduce_add": tr.reduce([halo])[0],
        "reduce_max": tr.reduce([halo], op="max", init=-1.0)[0],
        "allreduce_sum": tr.allreduce_sum([float(local.sum())]),
        "allreduce_vec": tr.allreduce_vec([rng.standard_normal(10)]),
        "allreduce_max": tr.allreduce_vec([rng.standard_normal(10)], "max"),
        "exscan": tr.exscan_sum([float(n_loc)]),
        "allgather_concat": tr.allgather_concat([local]),
        "fetch_ids": tr.fetch_ids([np.arange(r0, r0 + n_loc) * 1.0],
                                  [ids])[0],
        "fetch_rows": tr.fetch_rows(a, [rows])[0],
        "reduce_rows": tr.reduce_rows([trip], part.row_bounds,
                                      n).pop().to_scipy().toarray(),
    }


def group_ops(comm, blocks, part):
    """A controller's ``SocketGroup`` collectives and the transport over it
    (``transport_ops``)."""
    g = comm.group
    return {
        "alltoall": g.alltoall([(g.rank, d) for d in range(g.world)]),
        "gather0_bcast": g.gather0_bcast(np.arange(g.rank + 2.0),
                                         lambda p: np.concatenate(p)),
        "allgather": g.allgather({"rank": g.rank}),
        "transport": transport_ops(g.rank, g, blocks, part),
    }


def bridge(comm, n):
    """One controller of the multi-controller bridge on the n x n problem:
    its own rows, ``spmd_rs_setup`` (HMIS + extended+i) over the
    ``SocketGroup``, ``from_spmd`` with ``comm``, then a float64
    Chebyshev solve (the JAX package's tests/_mc_worker.py) and a float32
    Chebyshev(3) hierarchy refined to 1e-8 with float64 residuals; and the
    raises across controllers (TAP, Krylov, the preconditioner)."""
    import torch
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.core.types import (CoarsenType, InterpType,
                                             RelaxType)
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.krylov.cg import cg
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights

    a, block = aniso_view(n, comm.world, comm.rank)

    def make_transport(m):
        return MultiProcessTransport(comm.group, m)

    hier = spmd_rs_setup(a, form_rand_weights(n * n, 0), make_transport,
                         coarsen=CoarsenType.HMIS,
                         interp=InterpType.Extended)
    kw = dict(relax_type=RelaxType.Chebyshev, device=comm.device,
              comm=comm)
    dh = DeviceHierarchy.from_spmd(hier, make_transport, **kw)
    b = block.to_scipy() @ np.ones(n * n)
    res = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    out = {"rank": comm.rank, "r0": int(a.partition.row_bounds[comm.rank]),
           "x": dh.host(res.x), "n_iters": res.n_iters,
           "hist": res.res[res.res >= 0.0],
           "levels": [lvl.A.global_num_rows for lvl in dh.levels],
           "formats": [lvl.A.on_format for lvl in dh.levels]}
    dh32 = DeviceHierarchy.from_spmd(hier, make_transport,
                                     num_smooth_sweeps=3,
                                     dtype=torch.float32, **kw)
    out["x_mixed"], out["hist_mixed"] = dh32.solve_mixed(
        np.zeros_like(b), b, tol=1e-8)
    raises = {}
    for what, call in (
            ("tap", lambda: DeviceHierarchy.from_spmd(
                hier, make_transport, mesh=make_mesh2(1, comm.world),
                tap_amg=0, **kw)),
            ("cg", lambda: cg(dh.levels[0].A, dh.vector(b), dh.vector(b))),
            ("precond", dh.precond_pack)):
        try:
            call()
        except NotImplementedError as e:
            raises[what] = str(e)
    out["raises"] = raises
    return out


def fails(comm, bad_rank):
    """Controller ``bad_rank`` raises; the others wait on it."""
    if comm.rank == bad_rank:
        raise ValueError(f"controller {bad_rank} fails on purpose")
    comm.group.allgather(comm.rank)
    return comm.rank


def sleeps(comm, seconds):
    time.sleep(seconds)
    return comm.rank
