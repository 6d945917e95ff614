"""Flow-state and static-domain pytrees.

The reference interleaves per-cell state as ``cl_double4 {Z, Zmax, Qx, Qy}``
(reference: src/Domain/CDomain.cpp:143-191).  Here the layout is a
struct of arrays, so every field is its own contiguous ``(rows, cols)``
array and loads along a row coalesce.  All four prognostic fields share one dtype
(float32 or float64) chosen at configuration time, mirroring the
reference's single/double precision switch
(reference: src/OpenCL/Executors/COCLProgram.cpp:359-406).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import constants as C


class FlowState(NamedTuple):
    """Prognostic per-cell state.

    z:    free-surface level (FSL)       [m]
    zmax: maximum FSL seen so far        [m]  (NODATA marks disabled cells)
    qx:   unit-width discharge, x        [m^2/s]
    qy:   unit-width discharge, y        [m^2/s]
    """

    z: jax.Array
    zmax: jax.Array
    qx: jax.Array
    qy: jax.Array

    @property
    def shape(self):
        return self.z.shape

    @property
    def dtype(self):
        return self.z.dtype


class DomainStatic(NamedTuple):
    """Time-invariant per-cell data.

    zb:      bed elevation [m]
    manning: Manning roughness coefficient n
    """

    zb: jax.Array
    manning: jax.Array


class StepCarry(NamedTuple):
    """Scalar carry advanced by the per-iteration time controller.

    Mirrors the device-resident scalars of the reference
    (reference: src/Schemes/CSchemeGodunov.cpp:789-888 buffer list):
    simulation time, current timestep (negative = suspended at a sync
    point), hydrological accumulator, and the per-batch statistics
    counters read back by the host.
    """

    t: jax.Array            # simulation time [s]
    dt: jax.Array           # current timestep; <= 0 suspends the step
    t_hydro: jax.Array      # hydrological timestep accumulator [s]
    batch_dt_total: jax.Array
    batch_successful: jax.Array
    batch_skipped: jax.Array


def initial_carry(dtype, t0=0.0, dt0=0.01) -> StepCarry:
    """Fresh carry at simulation start."""
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return StepCarry(
        t=f(t0),
        dt=f(dt0),
        t_hydro=f(0.0),
        batch_dt_total=f(0.0),
        batch_successful=jnp.asarray(0, dtype=jnp.int32),
        batch_skipped=jnp.asarray(0, dtype=jnp.int32),
    )


def make_initial_state(zb, depth=None, fsl=None, qx=None, qy=None,
                       active=None, dtype=None) -> FlowState:
    """Build a FlowState from a bed raster plus optional initial conditions.

    Follows the reference's initial-condition ordering: the DEM defines the
    bed, depth or FSL defines z, everything else defaults to zero
    (reference: src/Domain/Cartesian/CDomainCartesian.cpp:163-283).
    Disabled cells (``active == False``) carry the NODATA sentinel in both
    z and zmax so the step kernels treat them exactly like the reference's
    -9999 cells.
    """
    zb = jnp.asarray(zb, dtype=dtype)
    dtype = zb.dtype
    if fsl is not None:
        z = jnp.asarray(fsl, dtype=dtype)
        z = jnp.maximum(z, zb)
    elif depth is not None:
        z = zb + jnp.asarray(depth, dtype=dtype)
    else:
        z = zb
    qx = jnp.zeros_like(zb) if qx is None else jnp.asarray(qx, dtype=dtype)
    qy = jnp.zeros_like(zb) if qy is None else jnp.asarray(qy, dtype=dtype)
    zmax = z
    if active is not None:
        active = jnp.asarray(active, dtype=bool)
        nod = jnp.asarray(C.NODATA, dtype=dtype)
        z = jnp.where(active, z, nod)
        zmax = jnp.where(active, zmax, nod)
        qx = jnp.where(active, qx, 0.0)
        qy = jnp.where(active, qy, 0.0)
    return FlowState(z=z, zmax=zmax, qx=qx, qy=qy)


def depth_of(state: FlowState, static: DomainStatic) -> jax.Array:
    """Water depth h = z - zb, clamped at zero, zero on disabled cells."""
    h = jnp.maximum(state.z - static.zb, 0.0)
    return jnp.where(state.zmax <= C.NODATA, 0.0, h)


def volume_of(state: FlowState, static: DomainStatic, dx, dy) -> jax.Array:
    """Total water volume over enabled cells (reference:
    src/Domain/Cartesian/CDomainCartesian.cpp:743-760)."""
    return jnp.sum(depth_of(state, static)) * dx * dy
