"""Hierarchy checkpoint and resume (copy of
raptor_tpu.multilevel.checkpoint).

The reference has no solver-state checkpointing; matrices round-trip via
PETSc binary / MatrixMarket (gallery/par_matrix_IO.cpp). Here the whole
setup product, every level's A and P plus the solver's knobs, goes into a
directory of ``.pm`` files and a ``meta.json`` with each level's row
bounds, so that an expensive setup can be reused across jobs and an
uneven partition comes back as it was. The layout is the JAX package's:
either package reads what the other writes.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.gallery.io import read_pm, write_pm
from raptor_tpu_torch.multilevel.level import Level


def save_hierarchy(ml, path) -> None:
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {
        "num_levels": ml.num_levels,
        "n_shards": ml.levels[0].A.partition.n_shards,
        "solve_tol": ml.solve_tol,
        "max_iterations": ml.max_iterations,
        "relax_type": ml.relax_type.name,
        "num_smooth_sweeps": ml.num_smooth_sweeps,
        "relax_weight": ml.relax_weight,
        "row_bounds": [
            [int(v) for v in lvl.A.partition.row_bounds]
            for lvl in ml.levels],
    }
    (path / "meta.json").write_text(json.dumps(meta))
    for i, lvl in enumerate(ml.levels):
        write_pm(path / f"A{i}.pm", lvl.A.global_csr)
        if lvl.P is not None:
            write_pm(path / f"P{i}.pm", lvl.P.global_csr)


def load_hierarchy(path):
    """A ``ParMultilevel`` with the saved levels and knobs and the coarse
    LU, ready for ``DeviceHierarchy``."""
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.multilevel.par_multilevel import ParMultilevel

    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    ml = ParMultilevel(0.0, relax_type=RelaxType[meta["relax_type"]])
    ml.solve_tol = meta["solve_tol"]
    ml.max_iterations = meta["max_iterations"]
    ml.num_smooth_sweeps = meta["num_smooth_sweeps"]
    ml.relax_weight = meta["relax_weight"]
    S = meta["n_shards"]

    levels = []
    for i in range(meta["num_levels"]):
        a = read_pm(path / f"A{i}.pm")
        rb = np.asarray(meta["row_bounds"][i], dtype=np.int64)
        part = Partition(a.n_rows, a.n_cols, S, rb, rb)
        pa = ParCSRMatrix(a, part)
        p = None
        pfile = path / f"P{i}.pm"
        if pfile.exists():
            pcsr = read_pm(pfile)
            rb_next = np.asarray(meta["row_bounds"][i + 1], dtype=np.int64)
            ppart = Partition(pcsr.n_rows, pcsr.n_cols, S, rb, rb_next)
            p = ParCSRMatrix(pcsr, ppart)
        levels.append(Level(A=pa, P=p))
    ml.levels = levels
    ml.duplicate_coarse()
    return ml
