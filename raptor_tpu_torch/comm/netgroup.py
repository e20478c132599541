"""Network process group (copy of raptor_tpu.comm.netgroup): tagged
point-to-point over TCP sockets, bootstrapped by a key-value rendezvous.

The wire the setup-phase ``Transport`` runs on across hosts, the
reference's MPI byte channel (core/comm_data.hpp Isend / Irecv message
schedules): every rank listens on a socket, publishes ``host:port``
through the rendezvous, and peers exchange length-prefixed pickled NumPy
messages over direct connections (one duplex socket per rank pair, a
background reader per peer). ``MultiProcessTransport(SocketGroup(...),
a_local)`` then gives the whole setup transport across processes and
hosts. The JAX package meets at jax.distributed's key-value store; the
port meets at a ``torch.distributed`` store (a ``TCPStore``, usually
behind a ``PrefixStore``: ``comm.bootstrap.init``).

Single-machine twin: ``multiproc.ProcessGroup`` (fork and queues), which
shares the collective layer through ``GroupBase``. The messages are
unpickled, so a group must only ever join ranks of one program.
"""

from __future__ import annotations

import datetime
import pickle
import socket
import struct
import threading
from typing import Dict, Tuple

from raptor_tpu_torch.comm.multiproc import GroupBase

_LEN = struct.Struct(">Q")
_HELLO = struct.Struct(">I")


class SocketGroup(GroupBase):
    """Tagged point-to-point and collectives over TCP for ``world`` ranks.

    ``store``: the rendezvous, a ``torch.distributed.Store`` (``set``, and
    ``wait`` / ``get`` with a timeout); a ``PrefixStore`` lets several
    groups share one store. ``host`` is the address this rank
    listens on and publishes to its peers. ``timeout_s`` is the liveness
    timeout of a connection and of a receive: peers legitimately spend
    minutes in local stages of a large setup, so it guards against a dead
    peer, not a slow one."""

    def __init__(self, rank: int, world: int, store,
                 host: str = "127.0.0.1", timeout_s: float = 900.0):
        self.rank = int(rank)
        self.world = int(world)
        self._seq = 0
        self._stash: Dict[Tuple, object] = {}
        self._cv = threading.Condition()
        self._conns: Dict[int, socket.socket] = {}
        self._wlocks: Dict[int, threading.Lock] = {}
        self._timeout = float(timeout_s)

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(world)
        port = self._srv.getsockname()[1]
        store.set(f"addr/{rank}", f"{host}:{port}")
        n_in = world - 1 - rank     # higher ranks dial me
        if n_in:
            threading.Thread(target=self._accept_loop, args=(n_in,),
                             daemon=True).start()
        wait = datetime.timedelta(seconds=self._timeout)
        for j in range(rank):       # I dial lower ranks
            key = f"addr/{j}"
            store.wait([key], wait)
            h, p = store.get(key).decode().rsplit(":", 1)
            c = socket.create_connection((h, int(p)),
                                         timeout=self._timeout)
            c.settimeout(None)
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            c.sendall(_HELLO.pack(rank))
            self._register(j, c)

    # --- wiring ------------------------------------------------------------
    def _accept_loop(self, n_in: int) -> None:
        try:
            for _ in range(n_in):
                c, _ = self._srv.accept()
                c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                peer = _HELLO.unpack(self._recv_exact(c, _HELLO.size))[0]
                self._register(int(peer), c)
        except (ConnectionError, OSError):
            return      # the listening socket closed (teardown)

    def _register(self, peer: int, conn: socket.socket) -> None:
        with self._cv:
            self._conns[peer] = conn
            self._wlocks[peer] = threading.Lock()
            self._cv.notify_all()
        threading.Thread(target=self._reader, args=(conn,),
                         daemon=True).start()

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf.extend(chunk)
        return bytes(buf)

    def _reader(self, conn: socket.socket) -> None:
        try:
            while True:
                ln = _LEN.unpack(self._recv_exact(conn, _LEN.size))[0]
                tag, src, payload = pickle.loads(
                    self._recv_exact(conn, ln))
                with self._cv:
                    self._stash[(tag, src)] = payload
                    self._cv.notify_all()
        except (ConnectionError, OSError):
            return      # peer done (teardown)

    def _conn(self, dst: int) -> socket.socket:
        with self._cv:
            if not self._cv.wait_for(lambda: dst in self._conns,
                                     timeout=self._timeout):
                raise RuntimeError(f"SocketGroup: rank {self.rank} has no "
                                   f"connection to rank {dst} after "
                                   f"{self._timeout:.0f} s")
            return self._conns[dst]

    # --- tagged point-to-point -------------------------------------------------
    def send(self, dst: int, tag, payload) -> None:
        if dst == self.rank:
            with self._cv:
                self._stash[(tag, self.rank)] = payload
                self._cv.notify_all()
            return
        blob = pickle.dumps((tag, self.rank, payload),
                            protocol=pickle.HIGHEST_PROTOCOL)
        c = self._conn(dst)
        with self._wlocks[dst]:
            c.sendall(_LEN.pack(len(blob)) + blob)

    def recv(self, tag, src: int):
        key = (tag, src)
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._stash,
                                     timeout=self._timeout):
                raise RuntimeError(
                    f"SocketGroup.recv: no message {key} from rank {src} "
                    f"within {self._timeout:.0f} s: the peer is dead or "
                    f"slower than the group's timeout_s")
            return self._stash.pop(key)

    def close(self) -> None:
        with self._cv:
            conns = list(self._conns.values())
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        self._srv.close()
