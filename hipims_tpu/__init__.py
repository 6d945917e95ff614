"""hipims-tpu: a 2-D shallow-water flood-simulation framework in JAX.

Built from scratch in JAX (jit / shard_map / Pallas) with the capabilities of
HiPIMS-OCL (first-order Godunov, MUSCL-Hancock and partial-inertial schemes,
HLLC fluxes, dynamic CFL timestepping, rainfall/discharge/depth boundaries,
raster I/O, multi-device domain decomposition) and none of its architecture.
"""

__version__ = "0.1.0"

from .state import DomainStatic, FlowState, StepCarry  # noqa: F401
