"""Twins of the JAX package's example and benchmark scripts (``examples/``)
for the PyTorch / CUDA port: one script per JAX script, with the same file
name, positional arguments and printed lines, run on the card unless
``--device cpu`` is given."""
