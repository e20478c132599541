"""The port's node-aware setup transport (``comm.tapgroup.TapGroup``) against
its flat schedule and against the JAX package's ``TapGroup``: the cases of
tests/test_tapgroup.py.

Each rank of ``run_spmd`` holds only its row block and runs the
distributed RS stages (strength, PMIS, extended+i, RAP) or the whole
``spmd_rs_setup`` over ``MultiProcessTransport(TapGroup(group, ppn), a)``.
The schedule only reorders messages, so every stage and every level must
equal the flat schedule's bit for bit, and the JAX package's ``TapGroup``
run on the same blocks; the sends it counts (``inter_sends`` across nodes,
``intra_sends`` within one) must be JAX's, and fewer messages must cross
nodes than under the flat schedule. Last, the same setup over the
``SocketGroup`` of 4 gloo controllers (``comm.launch.run_controllers``)
equals the one over the fork group.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

from raptor_tpu.comm import multiproc as jmp  # noqa: E402
from raptor_tpu.core.par_matrix import par_matrix_from_scipy  # noqa: E402
from raptor_tpu_torch.comm import launch  # noqa: E402
from raptor_tpu_torch.comm import multiproc as tmp  # noqa: E402
from raptor_tpu_torch.comm.transport import split_rows  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.gallery.stencils import (  # noqa: E402
    diffusion_stencil_2d, stencil_grid)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

PACKAGES = {"raptor_tpu": jmp, "raptor_tpu_torch": tmp}


def _aniso(n):
    return stencil_grid(diffusion_stencil_2d(*ANISO), (n, n)).to_scipy()


def _disconnected():
    """Two disconnected 12^2 components: on 4 ranks as 2 nodes of 2, half
    the rank pairs and one whole node pair exchange nothing."""
    g = _aniso(12)
    return sp.block_diag([g, g]).tocsr()


@functools.lru_cache(maxsize=None)
def _problem(name, world):
    """{package: (row blocks with global columns, partition)} and the glibc
    weights of problem ``name`` on ``world`` shards; the two packages'
    blocks are equal."""
    m = _disconnected() if name == "disconnected" else _aniso(int(name))
    n = m.shape[0]
    part = Partition.create(n, n, world)
    tblocks = split_rows(CSRMatrix.from_scipy(m), part.row_bounds)
    jA = par_matrix_from_scipy(m, world)
    jblocks = [blk.global_cols_csr(n) for blk in jA.shards()]
    for t, j in zip(tblocks, jblocks):
        assert (t.to_scipy() != j.to_scipy()).nnz == 0
    return ({"raptor_tpu_torch": (tblocks, part),
             "raptor_tpu": (jblocks, jA.partition)},
            form_rand_weights(n, 0))


# --- one rank's work (forked; host NumPy and native code only) -------------

def _group(pkg, group_raw, ppn, tap):
    """(the group the transport runs over, the base group that counts the
    point-to-point sends that cross nodes): the flat group itself, or a
    ``TapGroup`` over it."""
    mp = importlib.import_module(f"{pkg}.comm.multiproc")

    class Counting(mp.ProcessGroup):
        inter_p2p = 0

        def send(self, dst, tag, payload):
            self.inter_p2p += int(dst // ppn != self.rank // ppn)
            super().send(dst, tag, payload)

    base = Counting(group_raw.rank, group_raw.world, group_raw.inboxes)
    if not tap:
        return base, base
    tg = importlib.import_module(f"{pkg}.comm.tapgroup")
    return tg.TapGroup(base, ppn), base


def _counts(group, base):
    return {"inter_p2p": base.inter_p2p,
            "inter_sends": getattr(group, "inter_sends", None),
            "intra_sends": getattr(group, "intra_sends", None)}


def _serial(m):
    return (m.indptr, m.indices, m.data)


def _hier_worker(rank, group_raw, pkg, blocks, part, w, ppn, tap, coarsen,
                 interp):
    """The whole ``spmd_rs_setup`` of this rank's rows: every level's row
    block (global columns) and the send counts."""
    spmd = importlib.import_module(f"{pkg}.comm.spmd")
    types = importlib.import_module(f"{pkg}.core.types")
    par = importlib.import_module(f"{pkg}.core.par_matrix")
    mp = importlib.import_module(f"{pkg}.comm.multiproc")
    group, base = _group(pkg, group_raw, ppn, tap)
    a = par.ParCSRMatrix.from_local_rows([blocks[rank]], part,
                                         first_shard=rank)
    h = spmd.spmd_rs_setup(a, w,
                           lambda m: mp.MultiProcessTransport(group, m),
                           coarsen=getattr(types.CoarsenType, coarsen),
                           interp=getattr(types.InterpType, interp))
    levels = [_serial(lvl.a_local.shards()[0].global_cols_csr(
        lvl.a_local.partition.global_num_cols)) for lvl in h.levels]
    return levels, _counts(group, base)


def _stage_worker(rank, group_raw, pkg, blocks, part, w, ppn, tap):
    """One level of the distributed RS pipeline stage by stage (the
    reference's per-stage TAP tests: test_tap_splitting.cpp,
    test_tap_interpolation.cpp, test_tap_rap.cpp)."""
    ps = importlib.import_module(f"{pkg}.ruge_stuben.par_setup")
    spmd = importlib.import_module(f"{pkg}.comm.spmd")
    par = importlib.import_module(f"{pkg}.core.par_matrix")
    mp = importlib.import_module(f"{pkg}.comm.multiproc")
    group, base = _group(pkg, group_raw, ppn, tap)
    a = par.ParCSRMatrix.from_local_rows([blocks[rank]], part,
                                         first_shard=rank)
    tr = mp.MultiProcessTransport(group, a)
    masks = ps.dist_classical_strength(a, 0.25, tr=tr)
    s = ps.strength_masks_to_par(a, masks)
    states = np.asarray(ps.dist_split_pmis(
        s, w, tr=mp.MultiProcessTransport(group, s)))
    p_blocks, _ = ps.dist_extended_interpolation(a, s, states, tr=tr,
                                                 assemble=False)
    cb = spmd._coarse_bounds(states, part.row_bounds)
    c_blocks = ps.dist_rap(a, p_blocks, tr=tr, coarse_bounds=cb,
                           assemble=False)
    return {"masks": [np.asarray(m) for pair in masks for m in pair],
            "states": states,
            "P": [_serial(b) for b in p_blocks],
            "Ac": [_serial(b) for b in c_blocks]}, _counts(group, base)


def _run(pkg, worker, problem, world, ppn, tap, *extra):
    per_pkg, w = _problem(problem, world)
    blocks, part = per_pkg[pkg]
    return PACKAGES[pkg].run_spmd(world, worker, pkg, blocks, part, w, ppn,
                                  tap, *extra)


def _assert_same(a, b, what):
    """Nested results (dicts, lists, tuples of arrays) equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def _check(worker, problem, world, ppn, *extra):
    """The port's TapGroup against its flat schedule and JAX's TapGroup;
    returns (flat counts, TAP counts) of every rank."""
    flat = _run("raptor_tpu_torch", worker, problem, world, ppn, False,
                *extra)
    tap = _run("raptor_tpu_torch", worker, problem, world, ppn, True,
               *extra)
    jtap = _run("raptor_tpu", worker, problem, world, ppn, True, *extra)
    for r in range(world):
        _assert_same(tap[r][0], flat[r][0], f"rank {r}, flat")
        _assert_same(tap[r][0], jtap[r][0], f"rank {r}, JAX TapGroup")
        assert tap[r][1] == jtap[r][1], r
    return [f[1] for f in flat], [t[1] for t in tap]


@pytest.mark.parametrize("world,ppn", [(4, 2), (8, 4)])
def test_tapgroup_per_stage(world, ppn):
    """Strength, PMIS splitting, extended+i interpolation and RAP, each
    bit-equal under the node-aware schedule at both aspect ratios."""
    flat, tap = _check(_stage_worker, "20", world, ppn)
    assert (sum(t["inter_p2p"] for t in tap)
            < sum(f["inter_p2p"] for f in flat))


def test_tapgroup_single_node():
    """world == ppn: one node, so no message crosses nodes and the G step
    never fires (TAPComm on one node is its local_L_par_comm only)."""
    _, tap = _check(_hier_worker, "16", 4, 4, "PMIS", "ModClassical")
    assert all(t["inter_sends"] == 0 == t["inter_p2p"] for t in tap)
    assert all(t["intra_sends"] > 0 for t in tap)


def test_tapgroup_ppn1():
    """ppn == 1: every rank its own node, the schedule degenerates to the
    flat exchange (self-aggregation) and stays exact."""
    _, tap = _check(_hier_worker, "16", 4, 1, "PMIS", "ModClassical")
    assert all(t["inter_sends"] > 0 for t in tap)


def test_tapgroup_empty_pairs():
    """A disconnected operator: empty bundles flow through the aggregate
    and distribute steps without deadlock or corruption."""
    _check(_hier_worker, "disconnected", 4, 2, "PMIS", "ModClassical")


@pytest.mark.parametrize("world,ppn", [(4, 2), (8, 4)])
def test_tap_setup_transport(world, ppn):
    """The whole HMIS + extended+i setup: the same levels, and fewer
    messages across nodes (the aggregators' one message a node pair
    against every rank pair's)."""
    flat, tap = _check(_hier_worker, "24", world, ppn, "HMIS", "Extended")
    inter_flat = sum(f["inter_p2p"] for f in flat)
    assert sum(t["inter_p2p"] for t in tap) < inter_flat
    assert sum(t["inter_sends"] for t in tap) < inter_flat


def test_tapgroup_over_socket_group_controllers():
    """``TapGroup`` over the ``SocketGroup`` of 4 gloo controllers as 2
    nodes of 2 (``tests/_torch_mc.py:tapgroup_setup``): every controller's
    levels and send counts are those of the same schedule over the fork
    group."""
    ctl = launch.run_controllers(4, "_torch_mc:tapgroup_setup", (24, 2),
                                 device="cpu", timeout=300)
    ref = _run("raptor_tpu_torch", _hier_worker, "24", 4, 2, True, "HMIS",
               "Extended")
    for r in range(4):
        _assert_same(ctl[r]["levels"], ref[r][0], f"controller {r}")
        assert ctl[r]["inter_sends"] == ref[r][1]["inter_sends"]
        assert ctl[r]["intra_sends"] == ref[r][1]["intra_sends"]
    assert sum(c["inter_sends"] for c in ctl) > 0
