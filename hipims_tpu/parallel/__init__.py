"""Multi-device / multi-host scaling: mesh construction and sharding.

Replaces the reference's multi-domain decomposition + MPI halo machinery
(src/Domain/Links/CDomainLink.cpp, src/MPI/CMPIManager.cpp) with 2-D grid
sharding over a ``jax.sharding.Mesh``: XLA's SPMD partitioner inserts the
halo collective-permutes for the stencil shifts and turns the global CFL
max-reduction into an all-reduce across devices — the direct analogue of
the reference's partial-buffer halo copies and MPI_Allreduce(MIN).
"""

from .mesh import make_mesh, shard_simulation_arrays, grid_sharding  # noqa: F401
