"""Communication-model comparison, the twin of examples/model_tap_steps.py:
plain halo exchange against the topology-aware (TAP) schedule (the
reference's examples/model_tap_steps.cpp + profiling/profile_comm.cpp).

Prints per-schedule message counts and bytes by protocol class
(short / eager / rendezvous) and locality (intra-host against
inter-host) for a stencil problem on an H x L layout of the shards: the
static analysis the reference computes from live MPI traffic. It runs on
the host, in both packages; the device is only checked for
(``--device``), as in every twin.

Run: python examples_torch/model_tap_steps.py [grid_n] [hosts] [local] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.comm.plan import build_comm_plan
from raptor_tpu_torch.comm.tap import build_tap_plan
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.profiling.comm_model import (model_comm_plan,
                                                   model_tap_plan)


def stats_counts(st) -> dict:
    """The counts of a ``CommStats``: messages and bytes by class, the
    per-shard and per-host-pair maxima, bytes by locality, and those of
    each TAP step."""
    out = {"n_msgs": dict(st.n_msgs), "n_bytes": dict(st.n_bytes),
           "max_msgs_per_shard": st.max_msgs_per_shard,
           "max_bytes_per_shard": st.max_bytes_per_shard,
           "max_msgs_per_host_pair": st.max_msgs_per_host_pair,
           "max_bytes_per_host_pair": st.max_bytes_per_host_pair,
           "intra_host_bytes": st.intra_host_bytes,
           "inter_host_bytes": st.inter_host_bytes}
    if st.steps:
        out["steps"] = {k: stats_counts(v) for k, v in st.steps.items()}
    return out


def main(argv=None):
    args, _ = C.parse(argv, __doc__)
    n = C.arg(args, 0, 128)
    H = C.arg(args, 1, 2)
    L = C.arg(args, 2, 4)
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         H * L)
    plan = build_comm_plan(A)
    tap = build_tap_plan(A, H, L)

    plain = model_comm_plan(plan, shards_per_host=L)
    tapped = model_tap_plan(tap)
    print(f"== plain ParComm halo exchange ({H}x{L} mesh) ==")
    print(plain)
    print("== TAP 4-step schedule ==")
    print(tapped)
    saved = plain.inter_host_bytes - tapped.inter_host_bytes
    print(f"DCN bytes saved by TAP: {saved} "
          f"({100.0 * saved / max(1, plain.inter_host_bytes):.1f}%)")
    return C.finish({"plain": stats_counts(plain),
                     "tap": stats_counts(tapped), "saved": saved}, before)


if __name__ == "__main__":
    main()
