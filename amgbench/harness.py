"""One run of one cell: set-up, the measured window, the per-layer readings
(``trace``), and the check that decides ``correct``.

Set-up: the configuration's matrix (``reference.assemble``, a SciPy CSR)
handed to the port as one shard, the port's AMG setup, the entry packed
(the hierarchy in the mix's precision and what else the entry solves
with), a pool of right-hand sides b = A x made from the seed on the
device (``make_pool``), and one warm-up solve of the same shapes. Window:
solves of the pool's vectors, one after another, each from x0 = 0, for
``seconds``. After it: a sample of the solutions, drawn from the seed,
checked against the benchmark's own matrix by ``reference.residual``.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time

import numpy as np
import torch

from amgbench import catalog, timing, trace
from amgbench.reference import assemble
from amgbench.reference.residual import relative_residual
from raptor_tpu_torch.core.par_matrix import par_matrix_from_scipy
from raptor_tpu_torch.device.par import spmv

# top-level module names the run may not hold once its window has closed:
# the JAX package and JAX itself (the port's name begins with the former's,
# so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "raptor_tpu")
POOL_CHUNK = 1 << 26        # values a device call draws, 512 MiB of float64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def seed_bits(seed: int) -> int:
    """The seed as the unsigned 64 bits that torch and numpy take."""
    return int(seed) % (1 << 64)


def make_pool(seed: int, mix: dict, matrix, device) -> np.ndarray:
    """The mix's ``pool`` right-hand sides b = A x, as float64 host rows.
    Each x is ``x_base`` plus ``x_noise`` times a standard normal vector,
    drawn on the device from the seed; A is the benchmark's own CSR, and
    the products are taken on the device in calls of at most
    ``POOL_CHUNK`` values."""
    count, n = mix["pool"], matrix.shape[0]
    A = torch.sparse_csr_tensor(
        torch.from_numpy(matrix.indptr.astype(np.int64)),
        torch.from_numpy(matrix.indices.astype(np.int64)),
        torch.from_numpy(matrix.data.astype(np.float64)), matrix.shape,
        device=device, check_invariants=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    pool = np.empty((count, n))
    step = max(1, POOL_CHUNK // n)
    for i in range(0, count, step):
        k = min(step, count - i)
        x = torch.randn((n, k), generator=gen, device=device,
                        dtype=torch.float64)
        x.mul_(mix["x_noise"]).add_(mix["x_base"])
        pool[i:i + k] = (A @ x).T.cpu().numpy()
    return pool


class Spans:
    """Named host-clock spans of the run, each ended by a synchronize."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name] = time.perf_counter() - t0
        log(f"[{name}] {self.seconds[name]:.3f} s")


class Sample:
    """A uniform sample of ``k`` of the window's solves, drawn from the
    seed as they complete (reservoir sampling): the same seed and the same
    number of solves keep the same ones."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([seed_bits(seed), 1])
        self.k = k
        self.kept = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


class Context:
    """What a per-layer metric's reader reads: the cell, its mix, the
    set-up's ``spans``, the window's ``solves`` (steps, converged), and
    the probes after the window, each run once when first read (on the
    card only; None elsewhere)."""

    def __init__(self, cell, mix, entry, pool, spans, solves, matrix,
                 device):
        self.cell, self.mix, self.entry, self.pool = cell, mix, entry, pool
        self.spans, self.solves, self.matrix = spans, solves, matrix
        self.on_card = torch.device(device).type == "cuda"

    @functools.cached_property
    def vcycle_chain(self):
        """A chain of V-cycles of the hierarchy, each on the same
        normalised residual from zero, in the hierarchy's precision."""
        if not self.on_card:
            return None
        dh = self.entry.dh
        b = self.pool[0] / np.linalg.norm(self.pool[0])
        r = dh.vector(b)
        return timing.chain_ms(lambda: dh.vcycle(torch.zeros_like(r), r))

    @functools.cached_property
    def a0_spmv_ms(self):
        """Device ms of one ``device.par.spmv`` of the hierarchy's packed
        fine operator, back to back."""
        if not self.on_card:
            return None
        dh = self.entry.dh
        x = dh.vector(self.pool[0])
        return timing.kernel_ms(lambda: spmv(dh.levels[0].A, x))

    @functools.cached_property
    def trace(self):
        """``trace.traced_solves`` over two solves of the entry."""
        if not self.on_card:
            return None
        return trace.traced_solves(self.entry, self.pool)


def run_window(entry, pool, seconds: float, sample: Sample) -> dict:
    """Solves back to back until ``seconds`` have passed, the last one
    finished whole; every solve returns a host solution, so the clock
    stops after the card has finished."""
    solves = []
    t0 = now = time.perf_counter()
    while now - t0 < seconds:
        i = len(solves)
        s = entry.solve(pool[i % len(pool)])
        solves.append((s.steps, s.converged))
        sample.offer((i % len(pool), s.x, s.residual))
        now = time.perf_counter()
    return {"seconds": now - t0, "solves": solves}


def execute(bench: dict, cell_name: str, seed: int, seconds: float,
            trace_on: bool, device="cuda", config: dict = None,
            t0: float = None) -> dict:
    """One run of a cell on ``device``; ``config`` replaces the cell's
    configuration (the tests' small sizes), ``t0`` is the host clock at
    which set-up began. Returns the result line's fields."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = catalog.cell(bench, cell_name)
    config = catalog.config(bench, cell["config"]) if config is None \
        else config
    mix = catalog.traffic(cell["traffic"])
    spans = Spans(device)

    with spans("assemble"):
        matrix = assemble(config)
        A = par_matrix_from_scipy(matrix.copy(), 1)
    n = matrix.shape[0]
    log(f"matrix: {n} rows, {matrix.nnz} nonzeros")
    with spans("amg_setup"):
        ml = catalog.setup(config["setup"]["solver"]).build(config["setup"],
                                                             device)
        ml.setup(A)
    log("levels: " + ", ".join(str(lv.A.global_num_rows)
                               for lv in ml.levels))
    with spans("pack"):
        entry = catalog.entry(mix["entry"]).prepare(ml, mix, device)
    log("formats: " + "; ".join(entry.dh.format_summary()))
    with spans("pool"):
        pool = make_pool(seed, mix, matrix, device)
    with spans("warm_up"):
        warm = entry.solve(pool[0])
    log(f"warm-up solve: {warm.steps} steps, converged {warm.converged}")
    setup_s = time.perf_counter() - t0

    sample = Sample(seed, mix["checked"])
    window = run_window(entry, pool, seconds, sample)
    solves = window["solves"]
    ok = sum(1 for _, conv in solves if conv)
    log(f"window: {len(solves)} solves ({ok} converged) in "
        f"{window['seconds']:.3f} s")
    out = {"attempted": len(solves), "failed": len(solves) - ok}

    ctx = Context(cell, mix, entry, pool, spans.seconds, solves, matrix,
                  device)
    if trace_on:
        out["per_layer"] = {
            m["name"]: value for m in catalog.metrics_of(bench, "per_layer",
                                                         cell_name)
            if (value := catalog.reader(m["name"])(ctx)) is not None}
        if ctx.trace is not None:
            log(f"trace: {ctx.trace['device_events']} device events, "
                f"reduced in {ctx.trace['reduce_s']:.3f} s")
            out["busy_s"] = ctx.trace["busy_s"]
            out["trace_window_s"] = ctx.trace["window_s"]
            out["breakdown"] = {k: ctx.trace[k]
                                for k in ("device_ops", "idle_gaps")}
    else:
        out["end_to_end"] = {"setup_s": setup_s,
                             "solve_ms": window["seconds"] * 1e3
                             / max(ok, 1)}
    if torch.device(device).type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

    del ctx, entry, ml, A
    relres = [relative_residual(matrix, x, pool[i])
              for i, x, _ in sample.kept]
    worst = max(relres) if relres else None
    if relres:
        gap = max(abs(r - own) / own for r, (_, _, own)
                  in zip(relres, sample.kept))
        log(f"sample: {len(relres)} solutions; the reference's residual "
            f"against the program's own, largest relative gap {gap:.3e}")
    out["checks"] = {
        "max_relres": {"value": worst, "limit": mix["tol"]},
        "unconverged": {"value": len(solves) - ok, "limit": 0}}
    out["correct"] = (worst is not None and worst <= mix["tol"]
                      and ok == len(solves))
    return out
