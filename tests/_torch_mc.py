"""Workers of the port's multi-process tests (tests/test_torch_netgroup.py,
tests/test_torch_multicontroller.py, tests/test_torch_spmd.py,
tests/test_torch_tapgroup.py, tests/test_torch_mc_tap.py,
tests/test_torch_mc_krylov.py, tests/test_torch_mc_profile.py), beside
``_torch_parity``.

The controller functions (``bridge``, ``group_ops``, ``tapgroup_setup``,
``tap_solve``, ``krylov``, ``profile``, ``fails``, ``sleeps``) run in
interpreters
that ``raptor_tpu_torch.comm.launch`` starts, one per controller: they
import the port only, never JAX.
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
    Chebyshev(3) hierarchy refined to 1e-8 with float64 residuals."""
    import torch
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.core.types import (CoarsenType, InterpType,
                                             RelaxType)
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
    return out


def tapgroup_setup(comm, n, ppn):
    """One controller's ``spmd_rs_setup`` (HMIS + extended+i) of its rows
    of the n x n problem over ``TapGroup(comm.group, ppn)``: every level's
    row block (global columns, as CSR arrays) and the group's send
    counts."""
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.comm.tapgroup import TapGroup
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights
    a, _ = aniso_view(n, comm.world, comm.rank)
    group = TapGroup(comm.group, ppn)
    hier = spmd_rs_setup(a, form_rand_weights(n * n, 0),
                         lambda m: MultiProcessTransport(group, m))
    levels = []
    for lvl in hier.levels:
        m = lvl.a_local.shards()[0].global_cols_csr(
            lvl.a_local.partition.global_num_cols)
        levels.append((m.indptr, m.indices, m.data))
    return {"levels": levels, "inter_sends": group.inter_sends,
            "intra_sends": group.intra_sends}


def tap_solve(comm, n, layout, tap_amgs):
    """One controller of the TAP solve across controllers (the JAX
    package's tests/_mc_worker.py with ``tap``): its rows of the n x n
    problem, ``spmd_rs_setup`` (HMIS + extended+i) over its
    ``SocketGroup``, then for each ``tap_amg`` of ``tap_amgs``
    ``from_spmd`` on ``make_mesh2(*layout)`` with ``comm`` and a float64
    Chebyshev solve of b = A 1; its rows, history and cycles of each."""
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights

    a, block = aniso_view(n, comm.world, comm.rank)

    def make_transport(m):
        return MultiProcessTransport(comm.group, m)

    hier = spmd_rs_setup(a, form_rand_weights(n * n, 0), make_transport)
    b = block.to_scipy() @ np.ones(n * n)
    out = {"rank": comm.rank, "r0": int(a.partition.row_bounds[comm.rank])}
    for tap_amg in tap_amgs:
        dh = DeviceHierarchy.from_spmd(
            hier, make_transport, relax_type=RelaxType.Chebyshev,
            device=comm.device, comm=comm, mesh=make_mesh2(*layout),
            tap_amg=tap_amg)
        res = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
        out[tap_amg] = {"x": dh.host(res.x), "n_iters": res.n_iters,
                        "hist": res.res[res.res >= 0.0],
                        "tap_levels": [lvl.TA is not None
                                       for lvl in dh.levels]}
    return out


def krylov_problem(n, world, rank, max_levels, make_transport=None,
                   comm=None, device="cpu"):
    """The Krylov cases' operators and right-hand sides on the shards of
    ``rank`` (one rank's view across controllers, with ``comm`` and a
    transport factory across them; every shard with ``rank=None``):
    (the float64 ``from_spmd`` Chebyshev hierarchy of the n x n problem
    set up to ``max_levels`` levels, the fine operator plus the identity
    packed in float64, b = A 1 and a seeded standard normal b, each this
    view's rows, and the row bounds)."""
    import scipy.sparse as sp
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.comm.transport import (InProcessTransport,
                                                 split_rows)
    from raptor_tpu_torch.core.matrix import CSRMatrix
    from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
    from raptor_tpu_torch.core.partition import Partition
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device.par import device_put_matrix
    from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                                   stencil_grid)
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights
    make_transport = make_transport or InProcessTransport
    N = n * n
    g = stencil_grid(diffusion_stencil_2d(*ANISO), (n, n)).to_scipy()
    part = Partition.create(N, N, world)
    rb = np.asarray(part.row_bounds)
    shards = range(world) if rank is None else [rank]
    first = 0 if rank is None else rank
    r0, r1 = int(rb[first]), int(rb[shards[-1] + 1])

    def view(m):
        blocks = split_rows(CSRMatrix.from_scipy(m), rb)
        return ParCSRMatrix.from_local_rows([blocks[s] for s in shards],
                                            part, first_shard=first)

    a = view(g)
    hier = spmd_rs_setup(a, form_rand_weights(N, 0), make_transport,
                         max_levels=max_levels)
    dh = DeviceHierarchy.from_spmd(hier, make_transport,
                                   relax_type=RelaxType.Chebyshev,
                                   device=device, comm=comm)
    shifted = view((g + sp.identity(N)).tocsr())
    A1 = device_put_matrix(shifted, need_transpose=False, device=device,
                           tr=make_transport(shifted), comm=comm)
    b_ones = (g @ np.ones(N))[r0:r1]
    b_rand = np.random.default_rng(world).standard_normal(N)[r0:r1]
    return dh, A1, b_ones, b_rand, rb


def krylov(comm, n, max_levels, solvers, tol, max_iter):
    """One controller of the Krylov solvers across controllers: every
    entry of ``solvers`` (name: (module, function, preconditioned,
    keyword arguments), as tests/test_torch_krylov.py:SOLVERS) from zero
    on its view of ``krylov_problem``, the preconditioned ones on the
    hierarchy's fine operator with b = A 1 and ``precond_pack()``, the
    plain ones on A + I with the seeded b; each one's rows of x, residual
    history and iterations."""
    import importlib
    import torch
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.device.par import device_put_vector, host_vector

    def make_transport(m):
        return MultiProcessTransport(comm.group, m)

    dh, A1, b_ones, b_rand, rb = krylov_problem(
        n, comm.world, comm.rank, max_levels, make_transport, comm,
        comm.device)
    out = {"rank": comm.rank, "r0": int(rb[comm.rank])}
    for name, (mod, fn, pre, kw) in solvers.items():
        A, b = (dh.levels[0].A, b_ones) if pre else (A1, b_rand)
        if pre:
            kw = dict(kw, precond=dh.precond_pack())

        def vec(v):
            return device_put_vector(v, rb, A.rows_pad, dtype=torch.float64,
                                     device=comm.device,
                                     first_shard=comm.rank, n_local=1)

        solve = getattr(importlib.import_module(
            f"raptor_tpu_torch.krylov.{mod}"), fn)
        r = solve(A, vec(np.zeros_like(b)), vec(b), tol=tol,
                  max_iter=max_iter, **kw)
        out[name] = {"x": host_vector(r.x, rb, comm.rank), "res": r.res,
                     "n_iters": r.n_iters}
    return out


def profile(comm, n, layouts, reps):
    """One controller of ``profile_cycle`` across controllers: its rows of
    the n x n problem, ``spmd_rs_setup`` (HMIS + extended+i) over its
    ``SocketGroup``, then for each entry of ``layouts`` (None: the plain
    exchange; a (hosts, local) layout: TAP on every level of
    ``make_mesh2(*layout)``) a float64 Chebyshev ``from_spmd`` hierarchy
    with ``comm``: one V-cycle of b = A 1 from zero, ``profile_cycle`` and
    ``print_times`` (``reps`` each), and the same V-cycle again."""
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights

    a, block = aniso_view(n, comm.world, comm.rank)

    def make_transport(m):
        return MultiProcessTransport(comm.group, m)

    hier = spmd_rs_setup(a, form_rand_weights(n * n, 0), make_transport)
    b = block.to_scipy() @ np.ones(n * n)
    out = {"rank": comm.rank}
    for layout in layouts:
        tap = ({} if layout is None else
               {"mesh": make_mesh2(*layout), "tap_amg": 0})
        dh = DeviceHierarchy.from_spmd(
            hier, make_transport, relax_type=RelaxType.Chebyshev,
            device=comm.device, comm=comm, **tap)

        def cycle():
            return dh.host(dh.vcycle(dh.vector(np.zeros_like(b)),
                                     dh.vector(b)))

        before = cycle()
        rows = dh.profile_cycle(reps)
        table = dh.print_times(reps)
        out[layout] = {"rows": rows, "table": table, "before": before,
                       "after": cycle(),
                       "tap_levels": [lvl.TA is not None
                                      for lvl in dh.levels]}
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
