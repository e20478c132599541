"""The benchmark's plain reference: the problems' matrices, assembled from
the configurations' own formulas, and the residual check of the solves.
NumPy and SciPy only; nothing here imports the program under test.

Each problem kind is a module of its own, ``amgbench.reference.<kind>``,
with ``assemble(problem, grid) -> scipy.sparse.csr_matrix``.
"""

import importlib


def assemble(config: dict):
    """The float64 CSR matrix of a configuration: its ``problem`` on its
    ``grid``."""
    problem = config["problem"]
    return importlib.import_module(
        f"amgbench.reference.{problem['kind']}").assemble(problem,
                                                          config["grid"])
