"""Per-layer metrics, one module a metric: ``amgbench.metrics.<name>``
with ``read(ctx) -> float | None`` on ``harness.Context``. None leaves the
metric out of the result line: nothing to read in this cell or on this
device; a share of a roofline or a peak is never given as 0."""
