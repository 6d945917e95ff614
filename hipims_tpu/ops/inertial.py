"""Partial-inertial (Bates/de Almeida-type) simplified scheme, vectorised.

Mirrors ine_cacheDisabled / calculateInertialFlux (reference:
src/Schemes/CLSchemeInertial.clc:27-163, :335-378): per-face inertial
discharge with implicit Manning drag and a Froude-number limiter
(FROUDE_LIMIT = 0.8); the state's qx/qy slots store each cell's W/S face
discharges (a staggered layout).  The reference divides the FSL update by
DELTAY only and uses DELTAX in every face slope — both assume a square grid;
replicated for parity.

Each physical interface is evaluated twice in the reference, but the two
evaluations differ only through the computing cell's Manning n, so we
compute the shared (depth, slope, previous-discharge) once per interface and
specialise the drag denominator per side.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .godunov import SchemeParams


def face_discharge(manning, dt, prev_q, level_up, bed_up, level_down,
                    bed_down, dx, vs):
    """Inertial per-unit-width discharge across one face."""
    g = C.GRAVITY
    depth = jnp.maximum(level_down, level_up) - jnp.maximum(bed_up, bed_down)
    dry = depth < vs
    depth_s = jnp.where(dry, 1.0, depth)
    slope = (level_down - level_up) / dx

    q = (prev_q - g * depth_s * dt * slope) / (
        1.0 + g * depth_s * dt * manning * manning * jnp.abs(prev_q)
        / depth_s ** (10.0 / 3.0))

    # Froude limiter.
    celerity = jnp.sqrt(g * depth_s)
    froude = jnp.abs(q) / depth_s / celerity
    q_lim = depth_s * celerity * C.FROUDE_LIMIT
    q = jnp.where((q > 0.0) & (froude > C.FROUDE_LIMIT), q_lim, q)
    q = jnp.where((q < 0.0) & (froude > C.FROUDE_LIMIT), -q_lim, q)

    return jnp.where(dry, 0.0, q)


def inertial_interior(z, zmax, qx, qy, zb, n, dt, params: SchemeParams,
                      comp=None):
    """Update the interior of halo-extended arrays (radius 1); returns the
    four updated (M-2, Cc-2) interior fields (five with ``comp``; see
    ops/compensated.py)."""
    vs = params.very_small
    dx = params.dx

    # x-interfaces between (y, i) and (y, i+1): "up" = east side (i+1),
    # "down" = west side (i); previous discharge = east cell's stored W-face
    # value.  Two variants differing only in the computing cell's n.
    def x_flux(nv):
        return face_discharge(nv, dt, qx[:, 1:],
                               z[:, 1:], zb[:, 1:],
                               z[:, :-1], zb[:, :-1], dx, vs)

    qa_x = x_flux(n[:, :-1])   # used by the west cell as its E face
    qb_x = x_flux(n[:, 1:])    # used by the east cell as its W face

    # y-interfaces between (j, x) and (j+1, x): "up" = north (j+1).
    def y_flux(nv):
        return face_discharge(nv, dt, qy[1:, :],
                               z[1:, :], zb[1:, :],
                               z[:-1, :], zb[:-1, :], dx, vs)

    qa_y = y_flux(n[:-1, :])   # south cell's N face
    qb_y = y_flux(n[1:, :])    # north cell's S face

    sl = (slice(1, -1), slice(1, -1))
    dry = (z - zb) < vs
    dry5 = (dry[sl] & dry[1:-1, 2:] & dry[1:-1, :-2]
            & dry[2:, 1:-1] & dry[:-2, 1:-1])
    return inertial_cell_update(
        z[sl], zmax[sl], qx[sl], qy[sl], zb[sl],
        qa_x[1:-1, 1:], qb_x[1:-1, :-1], qa_y[1:, 1:-1], qb_y[:-1, 1:-1],
        dry5, dt, params, comp_c=None if comp is None else comp[sl])


def inertial_cell_update(zc, zmax_c, qx_c, qy_c, zbc, q_e, q_w, q_n, q_s,
                         dry5, dt, params: SchemeParams, comp_c=None):
    """Per-cell update from the cell's four face discharges (elementwise;
    shared by the XLA step and the GPU kernel, ops/triton_step.py).
    The new W/S discharges become the cell's stored qx/qy."""
    vs = params.very_small
    d_fsl = (q_e - q_w + q_n - q_s) / params.dy
    if comp_c is None:
        z_new = zc + dt * d_fsl
    else:
        z_new, comp_new = comp_add(zc, comp_c, dt * d_fsl)

    zmax_new = jnp.where(z_new > zmax_c, z_new, zmax_c)
    # Compensated runs judge dryness on the TRUE surface z + comp (see
    # godunov_cell_update).
    dry_new = ((z_new - zbc < vs) if comp_c is None
               else ((z_new - zbc) + comp_new < vs))
    z_new = jnp.where(dry_new, zbc, z_new)

    disabled = (zmax_c <= C.NODATA) | (zc == C.NODATA)
    keep = disabled | dry5 | (dt <= 0.0)

    outs = (jnp.where(keep, zc, z_new),
            jnp.where(keep, zmax_c, zmax_new),
            jnp.where(keep, qx_c, q_w),
            jnp.where(keep, qy_c, q_s))
    if comp_c is None:
        return outs
    comp_new = jnp.where(dry_new, 0.0, comp_new)
    return outs + (jnp.where(keep, comp_c, comp_new),)


def inertial_step(state: FlowState, static: DomainStatic, dt,
                  params: SchemeParams, comp=None):
    """One partial-inertial step on the whole grid (XLA backend).

    With ``comp`` returns (FlowState, comp_new); without, the FlowState."""
    z, zmax, qx, qy = (jnp.asarray(a) for a in state)
    zb, n = jnp.asarray(static.zb), jnp.asarray(static.manning)
    if comp is not None:
        comp = jnp.asarray(comp)

    out = inertial_interior(z, zmax, qx, qy, zb, n, dt, params, comp=comp)
    z_out, zmax_out, qx_out, qy_out = out[:4]

    sl = (slice(1, -1), slice(1, -1))
    new = FlowState(
        z=z.at[sl].set(z_out),
        zmax=zmax.at[sl].set(zmax_out),
        qx=qx.at[sl].set(qx_out),
        qy=qy.at[sl].set(qy_out),
    )
    if comp is None:
        return new
    return new, comp.at[sl].set(out[4])
