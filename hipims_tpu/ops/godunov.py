"""First-order Godunov-type finite-volume step, fully vectorised.

Semantics mirror gts_cacheDisabled (reference:
src/Schemes/CLSchemeGodunov.clc:164-384): per interior cell, reconstruct all
four interfaces depth-positively, solve HLLC, apply bed-slope source terms,
update (z, qx, qy), optional fused implicit friction, track max FSL and clamp
tiny depths to the bed.  Differences from the reference are purely
structural, not numerical:

* each interface is solved once (shared between its two cells) with the
  per-cell datum shift applied as a closed-form correction — see
  ops/riemann.py for the algebra;
* the ping-pong buffer pair becomes a pure state-in/state-out function
  (XLA donates buffers under jit);
* all branches (disabled cells, dry neighbourhoods, suspended timestep)
  become where-masks.

``godunov_interior`` takes arrays with a one-cell halo ring and returns
the updated interior; its per-cell half, ``godunov_cell_update``, is also
the body of the GPU kernel (ops/triton_step.py), so the two backends run
the same arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .friction import implicit_friction
from .riemann import local_datum, solve_interfaces


class SchemeParams(NamedTuple):
    """Static numerical-scheme configuration."""

    dx: float
    dy: float
    very_small: float = C.VERY_SMALL
    quite_small: float = C.QUITE_SMALL
    friction: bool = True
    # Vertical datum removed from device-side elevations (Domain.build
    # datum_shift); absolute-FSL boundary inputs subtract it.
    datum: float = 0.0


def _round_small(delta, vs):
    """Zero deltas with magnitude below the dry threshold (reference:
    src/Schemes/CLSchemeGodunov.clc:338-348)."""
    return jnp.where(jnp.abs(delta) < vs, 0.0, delta)


def godunov_interior(z, zmax, qx, qy, zb, n, dt, params: SchemeParams,
                     comp=None):
    """Update the interior of halo-extended arrays.

    Inputs are (R, Cc) arrays whose outer ring is halo/static; returns the
    four updated (R-2, Cc-2) interior fields.  dt may be a traced scalar;
    dt <= 0 or any per-cell skip condition leaves a cell unchanged.

    ``comp`` (optional, same shape as z) enables compensated-f32
    accumulation of z (see ops/compensated.py); when given a fifth output,
    the updated compensation interior, is returned.
    """
    vs = params.very_small

    # --- Interface solves (one per physical interface) -------------------
    # x-axis: between (y, i) [left] and (y, i+1) [right]; along = qx.
    fx = solve_interfaces(
        z[:, :-1], zb[:, :-1], qx[:, :-1], qy[:, :-1],
        z[:, 1:], zb[:, 1:], qx[:, 1:], qy[:, 1:], vs)
    # y-axis: between (j, x) [left/south] and (j+1, x) [right/north];
    # along = qy.  (North = +y: src/Domain/Cartesian/CLDomainCartesian.clc.)
    fy = solve_interfaces(
        z[:-1, :], zb[:-1, :], qy[:-1, :], qx[:-1, :],
        z[1:, :], zb[1:, :], qy[1:, :], qx[1:, :], vs)

    sl = (slice(1, -1), slice(1, -1))

    def face(fl, idx):
        return type(fl)(*(a[idx] for a in fl))

    f_e = face(fx, (slice(1, -1), slice(1, None)))
    f_w = face(fx, (slice(1, -1), slice(None, -1)))
    f_n = face(fy, (slice(1, None), slice(1, -1)))
    f_s = face(fy, (slice(None, -1), slice(1, -1)))

    dry = (z - zb) < vs
    dry5 = (dry[sl] & dry[1:-1, 2:] & dry[1:-1, :-2]
            & dry[2:, 1:-1] & dry[:-2, 1:-1])
    return godunov_cell_update(
        z[sl], zmax[sl], qx[sl], qy[sl], zb[sl], n[sl],
        f_e, f_w, f_n, f_s, dry5, dt, params,
        comp_c=None if comp is None else comp[sl])


def godunov_cell_update(zc, zmax_c, qx_c0, qy_c0, zbc, nc,
                        f_e, f_w, f_n, f_s, dry5, dt, params: SchemeParams,
                        comp_c=None):
    """Per-cell update from the cell's four solved faces (elementwise).

    ``f_e``/``f_w``/``f_n``/``f_s`` are the InterfaceFlux solutions of the
    cell's east, west, north and south faces (the cell is the left side
    of its east/north faces), ``dry5`` flags a dry five-cell
    neighbourhood.  Shared by the whole-grid XLA step and the GPU kernel
    (ops/triton_step.py), so both backends run the same arithmetic.
    Returns (z, zmax, qx, qy) or, with ``comp_c``, (z, zmax, qx, qy,
    comp)."""
    vs = params.very_small

    # Per-cell local datum and its momentum-flux term at each face.
    zb_e, c_e = local_datum(zc, f_e.zbm)
    zb_w, c_w = local_datum(zc, f_w.zbm)
    zb_n, c_n = local_datum(zc, f_n.zbm)
    zb_s, c_s = local_datum(zc, f_s.zbm)

    inv_dx = 1.0 / params.dx
    inv_dy = 1.0 / params.dy

    # Bed-slope source terms use the neighbour-side reconstructed surface and
    # the shifted local bed at each face (reference:
    # src/Schemes/CLSchemeGodunov.clc:321-325): z_face = h_far + zb_local.
    z_e = f_e.hr + zb_e
    z_w = f_w.hl + zb_w
    z_n = f_n.hr + zb_n
    z_s = f_s.hl + zb_s
    src_x = -C.GRAVITY * 0.5 * (z_e + z_w) * (zb_e - zb_w) * inv_dx
    src_y = -C.GRAVITY * 0.5 * (z_n + z_s) * (zb_n - zb_s) * inv_dy

    d_z = ((f_e.mass - f_w.mass) * inv_dx
           + (f_n.mass - f_s.mass) * inv_dy)
    d_qx = (((f_e.along + c_e) - (f_w.along + c_w)) * inv_dx
            + (f_n.cross - f_s.cross) * inv_dy - src_x)
    d_qy = ((f_e.cross - f_w.cross) * inv_dx
            + ((f_n.along + c_n) - (f_s.along + c_s)) * inv_dy - src_y)

    d_z = _round_small(d_z, vs)
    d_qx = _round_small(d_qx, vs)
    d_qy = _round_small(d_qy, vs)

    # Wet/dry stopping: any face flags it -> zero this cell's discharge
    # before applying the update.
    stop = f_e.stop_l | f_w.stop_r | f_n.stop_l | f_s.stop_r

    qx_c = jnp.where(stop, 0.0, qx_c0)
    qy_c = jnp.where(stop, 0.0, qy_c0)
    if comp_c is None:
        z_new = zc - dt * d_z
    else:
        z_new, comp_new = comp_add(zc, comp_c, -(dt * d_z))
    qx_new = qx_c - dt * d_qx
    qy_new = qy_c - dt * d_qy

    if params.friction:
        qx_new, qy_new = implicit_friction(
            z_new, qx_new, qy_new, zbc, nc,
            jnp.maximum(dt, vs), vs)

    zmax_new = jnp.where((z_new > zmax_c) & (zmax_c > -9990.0),
                         z_new, zmax_c)
    # Compensated runs judge dryness on the TRUE surface z + comp:
    # sub-ulp water lives entirely in the residue, and clamping on the
    # visible value alone would silently erase it.
    dry_new = ((z_new - zbc < vs) if comp_c is None
               else ((z_new - zbc) + comp_new < vs))
    z_new = jnp.where(dry_new, zbc, z_new)

    # --- Skip masks ------------------------------------------------------
    disabled = (zmax_c <= C.NODATA) | (zc == C.NODATA)
    keep = disabled | dry5 | (dt <= 0.0)

    z_out = jnp.where(keep, zc, z_new)
    zmax_out = jnp.where(keep, zmax_c, zmax_new)
    qx_out = jnp.where(keep, qx_c0, qx_new)
    qy_out = jnp.where(keep, qy_c0, qy_new)
    if comp_c is None:
        return z_out, zmax_out, qx_out, qy_out
    comp_new = jnp.where(dry_new, 0.0, comp_new)
    comp_out = jnp.where(keep, comp_c, comp_new)
    return z_out, zmax_out, qx_out, qy_out, comp_out


def godunov_step(state: FlowState, static: DomainStatic, dt,
                 params: SchemeParams, comp=None):
    """One first-order step on the whole grid (XLA backend).

    With ``comp`` (compensated-f32 z accumulation) returns
    (FlowState, comp_new); without it, just the FlowState."""
    z, zmax, qx, qy = (jnp.asarray(a) for a in
                       (state.z, state.zmax, state.qx, state.qy))
    zb, n = jnp.asarray(static.zb), jnp.asarray(static.manning)
    if comp is not None:
        comp = jnp.asarray(comp)

    out = godunov_interior(z, zmax, qx, qy, zb, n, dt, params, comp=comp)
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
