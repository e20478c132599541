"""The calls a traffic mix drives, one module an entry:
``amgbench.entries.<entry>`` with

- ``prepare(ml, mix, device)``: the entry at the mix's precision, packed
  from the set-up solver ``ml`` (its ``dh`` is the device hierarchy);
- ``prepare_control(ml, mix, device)``: the same call one precision below
  the one that sets the answer's accuracy (``calibrate.py`` reads it);

each with ``solve(b) -> Solve`` on a float64 host right-hand side, from
x0 = 0, returning the host solution as a user's call does."""

import dataclasses

import numpy as np


@dataclasses.dataclass
class Solve:
    x: np.ndarray       # the host solution
    steps: int          # refinements or Krylov iterations taken
    residual: float     # the program's own final relative residual
    converged: bool     # ... within the tolerance and the cap
