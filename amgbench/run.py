"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its result.

    python3 -m amgbench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

From the root of a checkout. Set-up, the measured window and the check are
``harness.execute``'s. With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, the
card's busy seconds over the traced span and the trace's breakdown. The
numbers the check compared, each beside its limit, are the last lines on
standard error and the last key of the result, which is the last line on
standard output.

Exits non-zero, with no result, without a CUDA card (or with fewer than
the cell asks for), when the program cannot be imported, or when JAX or
the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()    # set-up counts from here: imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# kernel and extension caches at fixed paths inside the checkout, so that
# only a cell's first run in a checkout compiles; the port keeps its own
# builds in raptor_tpu_torch/_build
CACHES = {"TORCH_EXTENSIONS_DIR": HERE / "_cache" / "torch_extensions",
          "TRITON_CACHE_DIR": HERE / "_cache" / "triton",
          "CUDA_CACHE_PATH": HERE / "_cache" / "cuda"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metric(bench, kind, name, value):
    unit = next(m["unit"] for m in bench[kind] if m["name"] == name)
    return {"value": value, "unit": unit}


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)

    import torch

    from amgbench import catalog
    bench = catalog.benchmark()
    cell = catalog.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from amgbench import harness, timing
    harness.log(f"card: {timing.power_limit()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    out = harness.execute(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3

    if args.trace:
        metrics = {name: metric(bench, "per_layer", name, value)
                   for name, value in out["per_layer"].items()}
    else:
        metrics = {m["name"]: metric(bench, "end_to_end", m["name"],
                                     out["end_to_end"][m["name"]])
                   for m in catalog.metrics_of(bench, "end_to_end",
                                               args.workload)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if "busy_s" in out:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
