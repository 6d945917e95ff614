"""Multi-host initialisation (the MPI-node analogue).

The reference's CMPIManager broadcasts configuration, exchanges device and
domain censuses, and runs collectives on a dedicated thread
(src/MPI/CMPIManager.cpp).  Under JAX, multi-host runs are the SAME
program on every host with ``jax.distributed`` providing the global device
view; the mesh in parallel/mesh.py then spans all hosts and the existing
GSPMD/shard_map collectives run over NVLink within a host and the network
across hosts.

Typical launch (one process per host, coordinator "host:port"):

    from hipims_tpu.parallel.distributed import initialize_cluster
    initialize_cluster(coordinator, n_proc, proc_id)
    mesh = make_mesh()                      # spans every host's devices
    sim = Simulation(domain, cfg, mesh=mesh)

Configuration broadcast: unlike the reference (rank 0 streams the XML to
every node, CMPIManager.cpp:185-252), every host simply reads the same
config path — deterministic parsing yields identical programs, which is
the SPMD contract.
"""

from __future__ import annotations

import jax


def initialize_cluster(coordinator_address=None, num_processes=None,
                       process_id=None):
    """Initialise jax.distributed.  On a cluster that JAX detects (e.g. a
    SLURM or Kubernetes launch) the arguments may come from the
    environment; elsewhere pass all three.  Returns True on success; already-initialised is treated
    as success, any other failure propagates (a half-initialised cluster
    must not silently fall back to single-host)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        return True
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return True
        raise


def gather_to_host(array):
    """Materialise a (possibly cross-process sharded) global array as a
    host numpy array on EVERY process.

    The reference streams link/progress data to rank 0 over MPI
    (src/MPI/CMPIManager.cpp:468-550); here a single allgather over the
    global sharding does the equivalent for outputs.  Single-process
    arrays pass through at zero cost."""
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(array)
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(array, tiled=True))


def host_summary() -> dict:
    """Per-host device census (the reference's exchangeDevices analogue,
    CMPIManager.cpp:257-360)."""
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=[str(d) for d in jax.local_devices()],
        global_device_count=len(jax.devices()),
    )


def is_coordinator() -> bool:
    """Rank-0 check for log/output gating (reference: rank-0-only console,
    src/main.cpp:561-578)."""
    return jax.process_index() == 0
