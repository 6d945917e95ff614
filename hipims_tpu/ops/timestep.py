"""CFL timestep reduction and the per-iteration time controller.

The reference runs a two-stage reduction (grid-stride max of per-cell wave
speeds into per-workgroup partials, then a single-work-item finalize that
also advances time and applies all the clamps:
src/Schemes/CLDynamicTimestep.clc:167-249 tst_Reduce, :28-146
tst_Advance_Normal).  Here the reduction is a single fused ``jnp.max`` (or
per-block partials from the GPU kernel, reduced the same way); the
controller is scalar arithmetic carried through the scan.

The reference's "negative timestep" convention is kept: when simulation time
reaches the sync/target time, dt flips negative, which suspends every kernel
(they all early-out on dt <= 0) while leaving the magnitude readable.  Under
``lax.scan`` this lets a fixed-length batch of steps idle harmlessly after
hitting the target, with no data-dependent control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import constants as C
from ..state import StepCarry


class TimestepParams(NamedTuple):
    """Static timestep configuration (specialised into the jitted step)."""

    courant: float = 0.5
    dynamic: bool = True          # CFL-driven vs fixed
    fixed_dt: float = 0.1
    simplified_speed: bool = False  # sqrt(gh) only (inertial scheme)
    minimum: float = C.TIMESTEP_MINIMUM
    maximum: float = C.TIMESTEP_MAXIMUM
    early_limit: float = C.TIMESTEP_EARLY_LIMIT
    early_duration: float = C.TIMESTEP_EARLY_LIMIT_DURATION
    start_minimum: float = C.TIMESTEP_START_MINIMUM
    start_duration: float = C.TIMESTEP_START_MINIMUM_DURATION


def max_wave_speed(z, zmax, qx, qy, zb, quite_small, simplified=False):
    """Global maximum per-cell wave speed for the CFL condition
    (reference: src/Schemes/CLDynamicTimestep.clc:185-223)."""
    return jnp.max(cell_wave_speed(z, zmax, qx, qy, zb, quite_small,
                                   simplified))


def cell_wave_speed(z, zmax, qx, qy, zb, quite_small, simplified=False):
    """Per-cell wave speed: max over axes of |u| + sqrt(g h) (or sqrt(g h)
    alone for the simplified/inertial variant) on enabled cells with depth
    above the QUITE_SMALL threshold, 0 elsewhere."""
    h = z - zb
    wet = (h > quite_small) & (zmax > C.NODATA)
    h_safe = jnp.where(wet, h, 1.0)
    celerity = jnp.sqrt(C.GRAVITY * jnp.maximum(h, 0.0))
    if simplified:
        speed = celerity
    else:
        speed = jnp.maximum(jnp.abs(qx), jnp.abs(qy)) / h_safe + celerity
    return jnp.where(wet, speed, 0.0)


def advance(carry: StepCarry, max_speed, sync_time, end_time, dx,
            params: TimestepParams) -> StepCarry:
    """Advance simulation time and compute the next timestep.

    Mirrors tst_Advance_Normal (src/Schemes/CLDynamicTimestep.clc:28-146):
    time moves by max(0, dt); the hydrological accumulator resets after it
    exceeds its own timestep; the new dt is CFL-limited then clamped by the
    start-up floor, the global minimum, the sync-time suspension flip, the
    early-simulation cap, the end-time, and the global maximum — in that
    exact order, which matters near sync points.
    """
    dt_eff = jnp.maximum(carry.dt, 0.0)
    t_new = carry.t + dt_eff
    batch_total = carry.batch_dt_total + dt_eff
    stepped = dt_eff > 0.0
    successful = carry.batch_successful + stepped.astype(jnp.int32)
    skipped = carry.batch_skipped + (~stepped).astype(jnp.int32)
    t_hydro = jnp.where(carry.t_hydro > C.TIMESTEP_HYDROLOGICAL,
                        dt_eff, carry.t_hydro + dt_eff)

    if params.dynamic:
        min_time = dx / max_speed  # max_speed == 0 -> inf -> capped below
        force_start = ((t_new < params.start_duration)
                       & (min_time < params.start_minimum))
        min_time = jnp.where(force_start, params.start_minimum, min_time)
        dt_new = params.courant * min_time
    else:
        dt_new = jnp.asarray(params.fixed_dt, dtype=carry.dt.dtype)
        dt_new = jnp.broadcast_to(dt_new, carry.dt.shape)

    dt_new = jnp.where((dt_new > 0.0) & (dt_new < params.minimum),
                       params.minimum, dt_new)

    # Suspension at the sync point: land exactly on it if any gap remains,
    # otherwise flip negative to idle until the host moves the target.
    remaining = sync_time - t_new
    reach = (t_new + dt_new) >= sync_time
    dt_new = jnp.where(reach,
                       jnp.where(remaining > C.VERY_SMALL, remaining, -dt_new),
                       dt_new)

    dt_new = jnp.where((t_new < params.early_duration)
                       & (dt_new > params.early_limit),
                       params.early_limit, dt_new)
    dt_new = jnp.where((t_new + dt_new) > end_time, end_time - t_new, dt_new)
    dt_new = jnp.where(dt_new > params.maximum, params.maximum, dt_new)

    return StepCarry(t=t_new, dt=dt_new, t_hydro=t_hydro,
                     batch_dt_total=batch_total,
                     batch_successful=successful,
                     batch_skipped=skipped)
