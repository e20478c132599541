"""The port's TCP setup group (``comm.netgroup.SocketGroup``), its
bootstrap (``comm.bootstrap``) and launcher (``comm.launch``).

Three controllers started by ``launch.run_controllers`` meet at a
``TCPStore`` and run the ``SocketGroup`` collectives and every
``MultiProcessTransport`` primitive over it; each rank's results equal
those of the same code over the fork-and-queue ``ProcessGroup``
(``run_spmd``). The transport works on the port's 20^2 anisotropic
matrix, rows split over 3 ranks.
"""

import datetime
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from raptor_tpu_torch.comm import bootstrap, launch  # noqa: E402
from raptor_tpu_torch.comm.multiproc import run_spmd  # noqa: E402
from raptor_tpu_torch.comm.netgroup import SocketGroup  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402

import _torch_mc  # noqa: E402
from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

WORLD = 3


@functools.lru_cache(maxsize=None)
def _problem():
    A = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (20, 20),
                             WORLD)
    return ([blk.global_cols_csr(400) for blk in A.shards()], A.partition)


@functools.lru_cache(maxsize=None)
def _socket_run():
    return launch.run_controllers(WORLD, "_torch_mc:group_ops", _problem(),
                                  device="cpu", timeout=120)


def _same(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def test_socket_group_collectives():
    """alltoall, gather0_bcast and allgather over TCP across 3 controllers
    give what each rank sent, in rank order."""
    res = _socket_run()
    for r, out in enumerate(res):
        assert out["alltoall"] == [(s, r) for s in range(WORLD)]
        np.testing.assert_array_equal(
            out["gather0_bcast"],
            np.concatenate([np.arange(s + 2.0) for s in range(WORLD)]))
        assert out["allgather"] == [{"rank": s} for s in range(WORLD)]


def test_socket_group_transport_matches_process_group():
    """Every MultiProcessTransport primitive over the SocketGroup equals
    the same calls over the fork-and-queue ProcessGroup, rank by rank."""
    want = run_spmd(WORLD, _torch_mc.transport_ops, *_problem())
    for r, out in enumerate(_socket_run()):
        _same(out["transport"], want[r], f"rank {r}")


def test_socket_group_recv_times_out():
    """A receive that nothing answers raises after the group's liveness
    timeout, naming the missing message."""
    store = dist.TCPStore("127.0.0.1", launch.free_port(), 1, is_master=True,
                          timeout=datetime.timedelta(seconds=30))
    g = SocketGroup(0, 1, dist.PrefixStore("t", store), timeout_s=0.2)
    try:
        assert g.allgather(7) == [7]
        with pytest.raises(RuntimeError, match=r"no message \(\(5, 'x'\)"):
            g.recv((5, "x"), 0)
    finally:
        g.close()


def test_launcher_raises_with_the_failing_controllers_log():
    with pytest.raises(RuntimeError, match="controller 1 fails on purpose"):
        launch.run_controllers(2, "_torch_mc:fails", (1,), device="cpu",
                               timeout=120)


def test_launcher_times_out():
    with pytest.raises(TimeoutError, match=r"still running after 8"):
        launch.run_controllers(2, "_torch_mc:sleeps", (600,), device="cpu",
                               timeout=8)


def test_bootstrap_refuses_what_it_does_not_run():
    """NCCL raises naming its ROADMAP item (one card cannot hold two NCCL
    ranks); an unknown backend, a bad rank or address raise ValueError;
    none of them touches the network."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 23"):
        bootstrap.init(0, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        bootstrap.init(0, 2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="rank 2 of a world of 2"):
        bootstrap.init(2, 2, device="cpu")
    with pytest.raises(ValueError, match="tcp://host:port"):
        bootstrap.init(0, 1, addr="127.0.0.1:1234", device="cpu")
    with pytest.raises(ValueError, match="module:function"):
        launch.run_controllers(1, "no_function_named", device="cpu")
