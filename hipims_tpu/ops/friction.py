"""Point-implicit Manning friction (Liang 2010).

Mirrors implicitFriction (reference: src/Schemes/CLFriction.clc:26-72):
a denominator-implicit update of both discharge components, clamped so
friction can only stop flow, never reverse it.  Vectorised over the grid.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import GRAVITY


def implicit_friction(z, qx, qy, zb, manning, dt, very_small):
    """Return (qx_new, qy_new) after one implicit friction step.

    No-op (returns inputs) where depth or total discharge is below the dry
    threshold, matching the reference's early-out.
    """
    vs = very_small
    h = z - zb
    q_mag = jnp.sqrt(qx * qx + qy * qy)
    skip = (h < vs) | (q_mag < vs)

    h_safe = jnp.where(skip, 1.0, h)
    q_safe = jnp.where(skip, 1.0, q_mag)

    # cf / h^2 = g n^2 h^(-1/3) / h^2 = g n^2 h^(-7/3): one exp/log pair
    # (h_safe > 0 on the non-skip path) replaces the reference's
    # pow(h, 1/3) plus two divisions, and lowers cleanly inside a Pallas kernel.
    inv_h2 = GRAVITY * manning * manning \
        * jnp.exp(jnp.log(h_safe) * (-7.0 / 3.0))
    sfx = -inv_h2 * qx * q_mag
    sfy = -inv_h2 * qy * q_mag
    inv_q = 1.0 / q_safe
    dt_ih2_iq = dt * inv_h2 * inv_q
    dx_den = 1.0 + dt_ih2_iq * (2.0 * qx * qx + qy * qy)
    dy_den = 1.0 + dt_ih2_iq * (qx * qx + 2.0 * qy * qy)
    fx = sfx / dx_den
    fy = sfy / dy_den

    # Friction may stop the flow but never reverse it.  dt is a scalar, so
    # one scalar reciprocal serves every lane.
    neg_inv_dt = -1.0 / dt
    limit_x = qx * neg_inv_dt
    limit_y = qy * neg_inv_dt
    fx = jnp.where(qx >= 0.0, jnp.maximum(fx, limit_x), jnp.minimum(fx, limit_x))
    fy = jnp.where(qy >= 0.0, jnp.maximum(fy, limit_y), jnp.minimum(fy, limit_y))

    qx_new = jnp.where(skip, qx, qx + dt * fx)
    qy_new = jnp.where(skip, qy, qy + dt * fy)
    # The clamp bound qx * (-1/dt) can sit 1 ulp past the exact -qx/dt when
    # dt is not a power of two, so qx + dt*fx could land one ulp across
    # zero; zero any sign flip so "friction never reverses flow" holds
    # exactly (reference: CLFriction.clc:61-66 compares against -q/dt).
    qx_new = jnp.where(qx_new * qx < 0.0, 0.0, qx_new)
    qy_new = jnp.where(qy_new * qy < 0.0, 0.0, qy_new)
    return qx_new, qy_new
