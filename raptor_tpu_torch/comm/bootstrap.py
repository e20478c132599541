"""Bootstrap of one controller of a multi-process run: the port's
counterpart of ``jax.distributed.initialize`` (the JAX package's
multi-controller worker, tests/_mc_worker.py:32-33).

``init(rank, world, addr)`` meets the other controllers at one
``torch.distributed.TCPStore`` (rank 0 serves it at ``addr``) and builds,
each behind its own ``PrefixStore``:

- the setup's group, a ``comm.netgroup.SocketGroup``, which
  ``comm.multiproc.MultiProcessTransport`` runs the host setup over;
- the device group, ``torch.distributed.init_process_group``, which the
  returned ``DeviceComm`` runs the solve's collectives over.

A controller holds one shard (the reference's MPI rank with its row
block). ``DeviceComm`` has the collectives the solve needs: the halo
exchange's ``all_to_all`` of a ``[S_dst, Q]`` send buffer and
``all_gather``, which the coarse solve and the inner products use (each
controller's per-shard partial dots, gathered into shard order, are summed
as the stacked route sums its own). ``mesh2(H, L)`` gives the two
sub-groups of a (host, local) layout that the topology-aware exchange
(``comm.tap``) runs its all-to-alls over: this controller's host's L
controllers, and the H controllers of its local index.

Only the gloo backend is wired. Gloo's collectives do not take every CUDA
tensor, so with ``backend="gloo"`` a ``DeviceComm`` copies a CUDA tensor
to the host, runs the collective there and copies the result back, on
every call: the backend's name decides that, never a caught error. NCCL,
the backend of one controller per card, needs a machine with several
cards (it refuses two ranks on one card): ROADMAP Queue 1 item 23.
"""

from __future__ import annotations

import datetime
import urllib.parse
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from raptor_tpu_torch.comm.netgroup import SocketGroup

BACKENDS = ("gloo",)


class DeviceComm:
    """One controller's collectives over the device group, and the setup
    group (``group``) beside them. Every rank calls every collective in
    the same order, as with MPI."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: torch.device, group: SocketGroup, store):
        self.rank = rank
        self.world = world
        self.backend = backend
        self.device = device
        self.group = group
        self._store = store      # rank 0 serves the rendezvous from it
        # gloo runs on host tensors: a tensor elsewhere goes through the
        # host explicitly (module docstring)
        self._via_host = backend == "gloo"
        self._mesh2: Dict[Tuple[int, int], Tuple["SubComm", "SubComm"]] = {}

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self._via_host else t

    def _all_to_all(self, send: torch.Tensor, size: int,
                    pg) -> torch.Tensor:
        if send.shape[0] != size:
            raise ValueError(f"all_to_all: a send buffer of {send.shape[0]} "
                             f"rows for {size} ranks")
        src = self._host(send)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=pg)
        return out.to(send.device)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send[d]`` goes to rank d; returns ``recv`` with ``recv[s]``
        what rank s sent this rank. ``send`` is ``[world, ...]``."""
        return self._all_to_all(send, self.world, None)

    def mesh2(self, n_hosts: int, n_local: int) -> Tuple["SubComm",
                                                           "SubComm"]:
        """(local, host): this rank's sub-groups of the (host, local)
        layout of ``device.par.Mesh2``, where rank r is local rank
        r % n_local of host r // n_local. ``local`` holds the n_local
        ranks of this rank's host, in local order; ``host`` the n_hosts
        ranks of its local index, in host order. Every rank builds every
        group (``torch.distributed.new_group`` is collective), the host
        groups first and then the local ones, at its first call for a
        layout; later calls return the cached pair."""
        key = (int(n_hosts), int(n_local))
        if key not in self._mesh2:
            H, L = key
            if H * L != self.world:
                raise ValueError(f"a {H} x {L} layout of {self.world} "
                                 f"controllers")
            h, l = divmod(self.rank, L)
            local = host = None
            for hh in range(H):
                ranks = [hh * L + j for j in range(L)]
                pg = dist.new_group(ranks)
                if hh == h:
                    local = SubComm(self, pg, ranks)
            for ll in range(L):
                ranks = [k * L + ll for k in range(H)]
                pg = dist.new_group(ranks)
                if ll == l:
                    host = SubComm(self, pg, ranks)
            self._mesh2[key] = (local, host)
        return self._mesh2[key]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t``, in rank order."""
        src = self._host(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.stack(parts).to(t.device)

    def close(self) -> None:
        """Leave both groups once every rank has finished its exchanges
        (a barrier on each first, so no socket closes under a message)."""
        self.group.allgather(None)
        self.group.close()
        dist.barrier()
        dist.destroy_process_group()


class SubComm:
    """The all-to-all among some of the controllers (a sub-group that this
    rank is in, from ``DeviceComm.mesh2``), staged through the host as
    the parent's collectives are. ``rank`` is this rank's index among
    ``ranks``."""

    def __init__(self, parent: DeviceComm, pg, ranks):
        self.ranks = tuple(ranks)
        self.world = len(self.ranks)
        self.rank = self.ranks.index(parent.rank)
        self._parent = parent
        self._pg = pg

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send[j]`` goes to the group's j-th rank; ``recv[j]`` is what
        it sent this rank."""
        return self._parent._all_to_all(send, self.world, self._pg)


def _parse(addr: str):
    u = urllib.parse.urlparse(addr)
    if u.scheme != "tcp" or not u.hostname or not u.port:
        raise ValueError(f"addr {addr!r}: expected tcp://host:port")
    return u.hostname, u.port


def init(rank: int, world: int, addr: str = "tcp://127.0.0.1:29500",
         backend: str = "gloo", device="cuda",
         timeout_s: float = 900.0) -> DeviceComm:
    """Join controller ``rank`` of ``world`` at ``addr`` (rank 0 serves
    the store there) and return its ``DeviceComm``; ``comm.group`` is the
    setup's ``SocketGroup``. ``device`` is where this controller's solve
    runs (CUDA by default; asking for it without a card raises).
    ``timeout_s`` bounds the rendezvous and every wait on a dead peer.
    ``backend="nccl"`` raises ``NotImplementedError`` (ROADMAP Queue 1
    item 23)."""
    from raptor_tpu_torch.device.par import resolve_device
    if backend == "nccl":
        raise NotImplementedError(
            "backend='nccl': NCCL refuses two ranks on one card, so the "
            "controllers of one card run over gloo; NCCL across several "
            "cards is ROADMAP Queue 1 item 23")
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; the port runs {BACKENDS}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    dev = resolve_device(device)
    host, port = _parse(addr)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, world, is_master=rank == 0,
                          timeout=timeout)
    group = SocketGroup(rank, world, dist.PrefixStore("setup", store),
                        host=host, timeout_s=timeout_s)
    dist.init_process_group(backend, store=dist.PrefixStore("device", store),
                            rank=rank, world_size=world, timeout=timeout)
    return DeviceComm(rank, world, backend, dev, group, store)
