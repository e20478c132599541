"""AMG setups, one module a solver: ``amgbench.setups.<solver>`` with
``build(setup: dict, device) -> solver``, the port's solver with the
configuration's knobs set and ``setup(A)`` not yet called."""
