"""Launcher of a multi-controller run on one machine: ``world``
interpreters, each one controller (``comm.bootstrap``), the counterpart
of the JAX package's test launcher (tests/test_multicontroller.py:32-62).

``run_controllers(world, "module:function", args)`` starts ``world``
fresh interpreters with ``subprocess``, never a fork: each imports torch
and sets up its card context afresh. Each calls ``bootstrap.init`` and
then ``function(comm, *args)``, and hands its result back through a
pickle file; the caller gets every rank's result in rank order. Any
rank's failure or the timeout ends every controller and raises with that
rank's log.

    python -m raptor_tpu_torch.comm.launch SPEC OUT

is one controller's entry (``SPEC`` a pickle the launcher writes, ``OUT``
where the result goes); it is not meant to be typed.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence

_PKG_ROOT = str(pathlib.Path(__file__).resolve().parents[2])


def free_port() -> int:
    """A TCP port on the loopback that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: pathlib.Path, n: int = 6000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except FileNotFoundError:
        return "(no log)"


def run_controllers(world: int, target: str, args: Sequence = (),
                    backend: str = "gloo", device="cuda",
                    timeout: float = 600.0) -> List:
    """Run ``target(comm, *args)`` (``target`` a "module:function" name the
    controllers can import) on ``world`` controllers of one machine and
    return their results in rank order. ``backend`` and ``device`` go to
    ``bootstrap.init``. Raises ``RuntimeError`` with the failing rank's
    log when a controller fails, ``TimeoutError`` with every log when they
    have not all finished within ``timeout`` seconds."""
    if ":" not in target:
        raise ValueError(f"target {target!r}: expected 'module:function'")
    addr = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # each controller takes an equal share of the cores for the thread
    # pools of torch and of numpy's BLAS: a pool of every core in each
    # controller oversubscribes the machine world times over (the pack's
    # power iterations ran 4.5x slower so on 8 controllers)
    threads = str(max(1, (os.cpu_count() or 1) // world))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        env[var] = threads
    with tempfile.TemporaryDirectory(prefix="raptor_mc_") as tmp:
        tmp = pathlib.Path(tmp)
        procs, logs, outs = [], [], []
        try:
            for r in range(world):
                spec = tmp / f"spec{r}.pkl"
                spec.write_bytes(pickle.dumps({
                    "rank": r, "world": world, "addr": addr,
                    "backend": backend, "device": str(device),
                    "target": target, "args": tuple(args),
                    "timeout": timeout,
                    "path": [p for p in sys.path if p]}))
                outs.append(tmp / f"out{r}.pkl")
                logs.append(tmp / f"log{r}.txt")
                with open(logs[r], "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "raptor_tpu_torch.comm.launch",
                         str(spec), str(outs[r])],
                        env=env, stdout=log, stderr=subprocess.STDOUT,
                        stdin=subprocess.DEVNULL))
            deadline = time.monotonic() + timeout
            running = set(range(world))
            while running:
                for r in sorted(running):
                    rc = procs[r].poll()
                    if rc is None:
                        continue
                    running.discard(r)
                    if rc != 0:
                        raise RuntimeError(
                            f"controller {r} of {world} ({target}) exited "
                            f"with code {rc}:\n{_tail(logs[r])}")
                if running and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"controllers {sorted(running)} of {world} "
                        f"({target}) still running after {timeout} s:\n"
                        + "\n".join(f"--- controller {r}\n{_tail(logs[r])}"
                                    for r in sorted(running)))
                time.sleep(0.05)
            return [pickle.loads(o.read_bytes()) for o in outs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def _main(spec_path: str, out_path: str) -> None:
    import importlib
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    sys.path[:0] = [p for p in spec["path"] if p not in sys.path]
    from raptor_tpu_torch.comm import bootstrap
    comm = bootstrap.init(spec["rank"], spec["world"], spec["addr"],
                          spec["backend"], spec["device"],
                          timeout_s=spec["timeout"])
    module, name = spec["target"].split(":")
    result = getattr(importlib.import_module(module), name)(
        comm, *spec["args"])
    comm.close()
    tmp = out_path + ".part"
    with open(tmp, "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, out_path)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
