"""The readings the check's limits are set from, at a cell's own size, with
one set-up for many seeds.

    python3 -m amgbench.calibrate --config <config> --traffic <mix> [...]
                                  --seeds <n> [...] --control-seeds <n> [...]

For each mix and seed: the pool of right-hand sides a run of that seed
makes, ``checked`` of them drawn from the seed (as many as a run checks),
solved by the program's entry and checked by the reference; the worst
relative residual is the seed's reading. Then the same for the control
(``prepare_control``: the entry one precision below the one that sets the
answer's accuracy) on the control seeds. One JSON line a seed and mix, and
a summary line a mix: the lower reading (the program's worst over its
seeds) and the upper one (the control's least). Needs the card, as a run
does; ``--device cpu --grid ...`` rehearses it at a small size on the
port's plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def readings(entry, matrix, mix, seeds, device, side):
    from amgbench import harness
    from amgbench.reference.residual import relative_residual
    worst = []
    for seed in seeds:
        t0 = time.perf_counter()
        pool = harness.make_pool(seed, mix, matrix, device)
        rng = np.random.default_rng([harness.seed_bits(seed), 2])
        picks = rng.choice(len(pool), size=mix["checked"], replace=False)
        rows = []
        for i in picks:
            s = entry.solve(pool[i])
            rows.append((relative_residual(matrix, s.x, pool[i]), s.steps,
                         s.converged, s.residual))
        worst.append(max(r[0] for r in rows))
        print(json.dumps({"side": side, "seed": seed,
                          "max_relres": worst[-1],
                          "max_gap": max(abs(r[0] - r[3]) / r[3]
                                         for r in rows),
                          "steps": [r[1] for r in rows],
                          "converged": all(r[2] for r in rows),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--grid", type=int, nargs="+",
                   help="another grid than the configuration's, to "
                        "rehearse at a small size")
    args = p.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 2
    from amgbench import catalog, harness
    from amgbench.reference import assemble
    from raptor_tpu_torch.core.par_matrix import par_matrix_from_scipy

    bench = catalog.benchmark()
    config = catalog.config(bench, args.config)
    if args.grid:
        config["grid"] = args.grid
    matrix = assemble(config)
    ml = catalog.setup(config["setup"]["solver"]).build(config["setup"],
                                                         args.device)
    ml.setup(par_matrix_from_scipy(matrix.copy(), 1))
    for name in args.traffic:
        mix = catalog.traffic(name)
        module = catalog.entry(mix["entry"])
        lower = readings(module.prepare(ml, mix, args.device), matrix, mix,
                         args.seeds, args.device, f"{name}:program")
        harness.sync(args.device)
        upper = readings(module.prepare_control(ml, mix, args.device),
                         matrix, mix, args.control_seeds, args.device,
                         f"{name}:control")
        print(json.dumps({"traffic": name, "config": args.config,
                          "lower": max(lower), "upper": min(upper),
                          "upper_over_lower": min(upper) / max(lower),
                          "limit": mix["tol"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
