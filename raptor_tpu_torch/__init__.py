"""raptor_tpu_torch: the PyTorch / CUDA port of raptor_tpu for NVIDIA Hopper.

The package mirrors ``raptor_tpu``'s layout module for module, so that
``raptor_tpu_torch/device/par.py`` sits beside ``raptor_tpu/device/par.py``.
It imports torch, numpy and scipy, never jax and never ``raptor_tpu``:
the host half (stencils, strength, CF splitting, interpolation, Galerkin
products) is its own copy, cut down to what the port runs, and binds the
repository's ``csrc/setup_kernels.cpp`` itself, so both packages build
bit-identical hierarchies.

- **Setup** (host): ``multilevel.par_multilevel.ParRugeStubenSolver``
  (classical or symmetric strength, RS/CLJP/Falgout/PMIS/HMIS splitting,
  direct, modified-classical and extended+i interpolation) and
  ``aggregation.solver.ParSmoothedAggregationSolver`` (symmetric
  strength, MIS(2) aggregation, tentative and Jacobi-smoothed
  prolongation) and ``multilevel.bsr_hierarchy.ParBSRRugeStubenSolver``
  (blocked AMG: nodal coarsening on the block-norm graph, per-component
  interpolation), all with native Galerkin products, a dense coarse LU
  and setup phase timers (``setup_times``, ``print_setup_times``). The
  gallery has the stencil problems and the Q1 finite-element Laplacian
  and plane-stress elasticity (``gallery.fem.par_fem``). Every solver
  runs ``setup_mode = "distributed"`` too: the per-shard stages of
  ``ruge_stuben.par_setup`` over ``comm.transport``'s in-process
  transport.
- **SPMD bridge**: ``comm.spmd`` builds the whole RS, SA or blocked
  hierarchy rank-locally from a local-view ``ParCSRMatrix``
  (``spmd_rs_setup``, ``spmd_sa_setup``, ``spmd_bsr_setup``), and
  ``DeviceHierarchy.from_spmd`` packs it for the device solve through the
  transport (``vector_local`` places per-rank vectors). Over real
  processes the setup runs on ``comm.multiproc.MultiProcessTransport``
  (``ProcessGroup`` or the TCP ``comm.netgroup.SocketGroup``, staged
  node by node by ``comm.tapgroup.TapGroup``), and with one controller
  per shard (``comm.bootstrap.init``, started by
  ``comm.launch.run_controllers``) ``from_spmd(..., comm=comm)`` solves
  across the controllers over ``torch.distributed`` (gloo), with the
  topology-aware exchange and the Krylov solvers too.
- **Solve** (device): ``multilevel.device_hierarchy.DeviceHierarchy``
  packs every level into stacked-shard ``[S, ...]`` tensors
  (``device.par.device_put_matrix``) and runs V-cycles with any smoother
  of ``device.relax``; ``krylov`` holds CG, BiCGStab and GMRES, with
  ``DeviceHierarchy.precond_pack()`` as their AMG preconditioner.
  ``multilevel.bsr_hierarchy.BSRDeviceHierarchy`` runs the blocked solve
  on block-ELL operators (``device.bsr``) with block-Chebyshev smoothing
  and per-component nodal transfers; its ``precond_pack()`` serves the
  same Krylov solvers. SpMVs
  in DIA, BDIA, windowed-ELL, sorted-scatter and BELL format launch the
  hand-written CUDA kernels in ``csrc/`` (``device.kernels``); on CPU
  tensors the same wrappers run the plain PyTorch versions in
  ``device.formats``.

Device entry points take ``device=`` and default to ``"cuda"``; they raise
when CUDA is asked for and absent.
"""

from raptor_tpu_torch.aggregation.solver import ParSmoothedAggregationSolver
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import (
    AggType, CoarsenType, InterpType, ProlongType, RelaxType, StrengthType)
from raptor_tpu_torch.gallery.fem import par_fem
from raptor_tpu_torch.multilevel.bsr_hierarchy import (
    BSRDeviceHierarchy, ParBSRRugeStubenSolver)
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver

__all__ = ["AggType", "BSRDeviceHierarchy", "CoarsenType", "InterpType",
           "ParBSRRugeStubenSolver", "ParCSRMatrix", "ParRugeStubenSolver",
           "ParSmoothedAggregationSolver", "Partition", "ProlongType",
           "RelaxType", "StrengthType", "par_fem"]
__version__ = "0.1.0"
