"""AMG setup phase benchmark, per component, the twin of
examples/benchmark_setup.py (the reference's benchmark_setup.cpp,
benchmark_rss.cpp): drives the RS pipeline level by level and times
strength, CF splitting, interpolation and the RAP Galerkin product
separately. The stages run on the host, as in the JAX script.

Run: python examples_torch/benchmark_setup.py [grid_n] [coarsen] [interp] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, StrengthType
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.profiling.timers import Profiler
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf
from raptor_tpu_torch.ruge_stuben.interpolation import par_interpolation
from raptor_tpu_torch.ruge_stuben.strength import strength
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights

INTERP = {"Direct": "direct", "ModClassical": "mod_classical",
          "Extended": "extended"}


def main(argv=None):
    args, _ = C.parse(argv, __doc__)
    n = C.arg(args, 0, 512)
    coarsen = C.arg(args, 1, CoarsenType.CLJP, lambda s: CoarsenType[s])
    interp = C.arg(args, 2, "mod_classical", lambda s: INTERP[s])
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n), 1)
    weights = form_rand_weights(A.global_num_rows, 0)

    prof = Profiler()
    a = A
    t0 = time.perf_counter()
    level = 0
    rows = []
    print(f"{'lvl':>3} {'rows':>9} {'nnz':>10}")
    while a.global_num_rows > 50 and level < 25:
        with prof.phase("strength"):
            s = strength(a, StrengthType.Classical, 0.25)
        w = weights[:a.global_num_rows]
        with prof.phase("cf_splitting"):
            if coarsen == CoarsenType.CLJP:
                states = cf.split_cljp(s, w)
            elif coarsen == CoarsenType.PMIS:
                states = cf.split_pmis(s, w)
            elif coarsen == CoarsenType.HMIS:
                states = cf.split_hmis(s, w)
            else:
                states = cf.split_falgout(s, w)
        with prof.phase("interpolation"):
            p = par_interpolation(a, s, states, interp)
        with prof.phase("RAP"):
            ap = a.multiply(p)
            ac = p.transpose().multiply(ap)
        print(f"{level:>3} {a.global_num_rows:>9} {a.nnz:>10}")
        rows.append((a.global_num_rows, a.nnz))
        a = ac
        level += 1
    total = time.perf_counter() - t0

    print(C.report(prof))
    print(f"total setup: {total:.3f}s "
          f"({A.nnz / total / 1e6:.2f} Mnnz/s over the fine-level nnz)")
    return C.finish({"levels": rows}, before)


if __name__ == "__main__":
    main()
