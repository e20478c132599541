"""The benchmark of the PyTorch and CUDA port (``raptor_tpu_torch``): AMG
solves of many right-hand sides on one card, driven by the files under
``configs/``, ``traffic/``, ``metrics/``, ``setups/`` and ``entries/`` that
``BENCHMARK.json`` names. ``python -m amgbench.run --help``; README.md.

Importing this package imports nothing else: the program is imported by the
run, after it has found a card.
"""
