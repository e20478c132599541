"""What several twins share: the command line, the device, timing with
CUDA events behind a synchronize, the phase timers' report and the kernel
launch counts of a run."""

import argparse
import time

import torch

from raptor_tpu_torch.device import kernels
from raptor_tpu_torch.device import par as dpar

# the stacked shard count where a JAX script defaults to len(jax.devices()):
# the JAX package's 8-device CPU mesh and the port's tests
N_DEV = 8


def parse(argv, doc):
    """(positional arguments, device) of a twin's command line: the JAX
    script's positional arguments, in its order, and ``--device`` (default
    "cuda"). Raises through ``resolve_device`` when CUDA is asked for and
    absent: a twin never drops to the CPU on its own."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch "
                    "versions of the kernels)")
    ns = ap.parse_args(argv)
    dpar.resolve_device(ns.device)
    return ns.args, ns.device


def check(ok, what):
    """Raise unless ``ok``: a twin's own checks of what it computed (the
    JAX scripts' asserts, kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def arg(args, i, default, cast=int):
    """The i-th positional argument cast, or ``default`` when absent (the
    JAX scripts' ``sys.argv[i + 1] if len(sys.argv) > i + 1 else ...``)."""
    return cast(args[i]) if len(args) > i else default


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def seconds(device, fn):
    """(fn(), seconds of it): CUDA events around the call behind a
    synchronize on the card, the host clock elsewhere."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) * 1e-3


def report(prof) -> str:
    """The JAX package's ``Profiler.report`` table."""
    lines = ["phase timers:"]
    for k in sorted(prof.times):
        lines.append(f"  {k:30s} {prof.times[k]:10.4f}s  "
                     f"x{prof.counts[k]}")
    return "\n".join(lines)


def delta_time(device, chain, *args, n_lo=2, n_hi=502):
    """Seconds of one step of ``chain(*args, n)`` (n steps): the least of
    five runs at ``n_hi`` less the least of five at ``n_lo``, over
    ``n_hi - n_lo``, after one run of each (the JAX scripts'
    ``_delta_time``, each run timed by ``seconds``)."""
    def timed(n):
        return seconds(device, lambda: chain(*args, n))[1]
    timed(n_lo), timed(n_hi)
    lo = min(timed(n_lo) for _ in range(5))
    hi = min(timed(n_hi) for _ in range(5))
    return (hi - lo) / (n_hi - n_lo)


def launches() -> dict:
    """The kernel launch counts so far (``device.kernels.LAUNCHES``)."""
    return dict(kernels.LAUNCHES)


def finish(out: dict, before: dict) -> dict:
    """Add the launches made since ``before`` to a twin's counts, print
    them, and return the counts."""
    out["launches"] = {k: v - before.get(k, 0)
                       for k, v in kernels.LAUNCHES.items()}
    print("kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in out["launches"].items()))
    return out


def levels(ml):
    """[(rows, nnz)] of every level, as ``print_hierarchy`` prints them."""
    return [(lvl.A.global_num_rows, lvl.A.nnz) for lvl in ml.levels]


def lane_pad(device) -> int:
    """The padding ``DeviceHierarchy`` gives a device on its own: 128 on
    the card, 1 elsewhere; a matrix that a hierarchy's V-cycle
    preconditions is packed with the same."""
    return 128 if torch.device(device).type == "cuda" else 1


def warm_up(dh, x, b):
    """One V-cycle behind a synchronize: where a JAX script solves once to
    compile before the timed solve, the eager port has nothing to compile,
    and one cycle loads and allocates what the first solve would."""
    dh.vcycle(x, b)
    sync(dh.device)
