"""The benchmark's tests run on the CPU with the port's plain versions;
those marked ``cuda`` skip there. ``python -m pytest amgbench/tests`` from
the repository's root."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small_config(bench, cell_name, grid):
    """A cell's configuration at a grid a test run holds."""
    from amgbench import catalog
    config = catalog.config(bench, catalog.cell(bench, cell_name)["config"])
    config["grid"] = list(grid)
    return config
