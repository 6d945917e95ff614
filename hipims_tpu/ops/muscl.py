"""Second-order MUSCL-Hancock scheme, fully vectorised.

Mirrors the predictor mch_1st (reference:
src/Schemes/CLSchemeMUSCLHancock.clc:301-526) and corrector mch_2nd_cacheNone
(:534-801 with the estimate-based reconstructInterface at :1119-1230).  As in
ops/godunov.py, every interface is solved once with the per-cell datum shift
applied as a closed-form correction; the predictor's separate/contiguous
face-buffer layouts collapse into four plain arrays that XLA keeps fused.

``muscl_interior`` is the core (stencil radius 2): it takes arrays with a
two-cell halo ring and returns the updated interior; the whole-grid step
and the halo-deep mesh window both call it.  Note the reference's MUSCL
corrector leaves a TWO-cell
static ring (bounds check at src/Schemes/CLSchemeMUSCLHancock.clc:568-573).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .friction import implicit_friction
from .godunov import SchemeParams, _round_small
from .limiters import slope_vector
from .riemann import local_datum, solve_interfaces_muscl


# First-order fallback thresholds (reference: the predictor's dry/edge
# guards, src/Schemes/CLSchemeMUSCLHancock.clc:320-335): a nearly dry cell
# or any disabled/boundary neighbour drops to first order.  zmax <= -9998
# covers both the -9999 disabled sentinel and the 9999.9 edge-wall cells'
# untouched initial zmax.
FIRST_ORDER_DRY_DEPTH = 1e-5
SENTINEL_ZMAX = -9998.0


def first_order_mask(hc, zmax_n, zmax_e, zmax_s, zmax_w):
    """Cells that must fall back to first order in the predictor (and whose
    slopes are therefore stored/recomputed as zero)."""
    return ((hc < FIRST_ORDER_DRY_DEPTH)
            | (zmax_n <= SENTINEL_ZMAX) | (zmax_e <= SENTINEL_ZMAX)
            | (zmax_s <= SENTINEL_ZMAX) | (zmax_w <= SENTINEL_ZMAX))


class FaceExtrap(NamedTuple):
    """Face-extrapolated estimate (z, h, qx, qy), one entry per cell."""

    z: jnp.ndarray
    h: jnp.ndarray
    qx: jnp.ndarray
    qy: jnp.ndarray


def _flux_x(face: FaceExtrap, vs):
    """SWE flux vector in x from an extrapolated face state (reference:
    estimateFluxVectorX, src/Schemes/CLSchemeMUSCLHancock.clc:420-443)."""
    u = jnp.where(face.h < vs, 0.0, face.qx
                  / jnp.where(face.h < vs, 1.0, face.h))
    p = 0.5 * C.GRAVITY * (face.z * face.z
                           - 2.0 * (face.z - face.h) * face.z)
    return face.qx, u * face.qx + p, u * face.qy


def _flux_y(face: FaceExtrap, vs):
    v = jnp.where(face.h < vs, 0.0, face.qy
                  / jnp.where(face.h < vs, 1.0, face.h))
    p = 0.5 * C.GRAVITY * (face.z * face.z
                           - 2.0 * (face.z - face.h) * face.z)
    return face.qy, v * face.qx, v * face.qy + p


def muscl_predictor_interior(z, zmax, qx, qy, zb, dt,
                             params: SchemeParams):
    """Half-timestep predictor for the one-ring interior of (M, Cc) arrays.

    Returns four FaceExtrap slabs of shape (M-2, Cc-2) ordered N, E, S, W,
    where slab[j, i] belongs to cell (j+1, i+1).
    """
    vs = params.very_small
    sl = (slice(1, -1), slice(1, -1))
    n_i = (slice(2, None), slice(1, -1))
    s_i = (slice(None, -2), slice(1, -1))
    e_i = (slice(1, -1), slice(2, None))
    w_i = (slice(1, -1), slice(None, -2))

    zc, zbc = z[sl], zb[sl]
    hc = zc - zbc
    qxc, qyc = qx[sl], qy[sl]

    first_order = first_order_mask(hc, zmax[n_i], zmax[e_i],
                                   zmax[s_i], zmax[w_i])

    sx = slope_vector(z[w_i], zb[w_i], qx[w_i], qy[w_i],
                      zc, zbc, qxc, qyc,
                      z[e_i], zb[e_i], qx[e_i], qy[e_i], vs)
    sy = slope_vector(z[s_i], zb[s_i], qx[s_i], qy[s_i],
                      zc, zbc, qxc, qyc,
                      z[n_i], zb[n_i], qx[n_i], qy[n_i], vs)

    def extrap(zv, hv, qxv, qyv, slope, coef):
        return FaceExtrap(z=zv + coef * slope[0], h=hv + coef * slope[1],
                          qx=qxv + coef * slope[2], qy=qyv + coef * slope[3])

    ex_n0 = extrap(zc, hc, qxc, qyc, sy, +0.5)
    ex_e0 = extrap(zc, hc, qxc, qyc, sx, +0.5)
    ex_s0 = extrap(zc, hc, qxc, qyc, sy, -0.5)
    ex_w0 = extrap(zc, hc, qxc, qyc, sx, -0.5)

    fn = _flux_y(ex_n0, vs)
    fe = _flux_x(ex_e0, vs)
    fs = _flux_y(ex_s0, vs)
    fw = _flux_x(ex_w0, vs)

    inv_dx, inv_dy = 1.0 / params.dx, 1.0 / params.dy
    src_x = -C.GRAVITY * 0.5 * (ex_e0.z + ex_w0.z) \
        * ((ex_e0.z - ex_e0.h) - (ex_w0.z - ex_w0.h)) * inv_dx
    src_y = -C.GRAVITY * 0.5 * (ex_n0.z + ex_s0.z) \
        * ((ex_n0.z - ex_n0.h) - (ex_s0.z - ex_s0.h)) * inv_dy

    d_z = (fe[0] - fw[0]) * inv_dx + (fn[0] - fs[0]) * inv_dy
    d_qx = (fe[1] - fw[1]) * inv_dx + (fn[1] - fs[1]) * inv_dy - src_x
    d_qy = (fe[2] - fw[2]) * inv_dx + (fn[2] - fs[2]) * inv_dy - src_y
    d_z = _round_small(d_z, vs)
    d_qx = _round_small(d_qx, vs)
    d_qy = _round_small(d_qy, vs)

    z_half = zc - 0.5 * dt * d_z
    qx_half = qxc - 0.5 * dt * d_qx
    qy_half = qyc - 0.5 * dt * d_qy
    h_half = z_half - zbc

    ex_n1 = extrap(z_half, h_half, qx_half, qy_half, sy, +0.5)
    ex_e1 = extrap(z_half, h_half, qx_half, qy_half, sx, +0.5)
    ex_s1 = extrap(z_half, h_half, qx_half, qy_half, sy, -0.5)
    ex_w1 = extrap(z_half, h_half, qx_half, qy_half, sx, -0.5)

    first_order_face = FaceExtrap(z=zc, h=hc, qx=qxc, qy=qyc)

    def pick(sec):
        return FaceExtrap(*(jnp.where(first_order, f, s)
                            for s, f in zip(sec, first_order_face)))

    return tuple(pick(ex) for ex in (ex_n1, ex_e1, ex_s1, ex_w1))


def muscl_corrector_interior(z, zmax, qx, qy, zb, n, slabs, dt,
                             params: SchemeParams, comp=None):
    """Full-timestep corrector for the two-ring interior of (M, Cc) arrays.

    ``slabs`` are the predictor's (M-2, Cc-2) FaceExtrap slabs, where
    slab[j, i] belongs to cell (j+1, i+1) (no ring padding — the ring
    extraps are never consumed).  Returns the four updated (M-4, Cc-4) interior
    fields (plus the updated compensation plane when ``comp`` is given;
    see ops/compensated.py — the half-step predictor state is a
    within-step temporary and is intentionally not compensated).
    """
    vs = params.very_small
    ex_n, ex_e, ex_s, ex_w = slabs

    # x-axis interfaces between cells (r, c)|(r, c+1), c in [1, Cc-3):
    # left cell's E estimate vs right cell's W estimate; raw discharges
    # from the corresponding cells.
    fx = solve_interfaces_muscl(
        ex_e.z[:, :-1], ex_e.h[:, :-1], ex_e.qx[:, :-1], ex_e.qy[:, :-1],
        ex_w.z[:, 1:], ex_w.h[:, 1:], ex_w.qx[:, 1:], ex_w.qy[:, 1:],
        qx[1:-1, 1:-2], qx[1:-1, 2:-1], vs,
        qcl_cell=qy[1:-1, 1:-2], qcr_cell=qy[1:-1, 2:-1])
    # y-axis interfaces: south cell's N estimate vs north cell's S estimate;
    # along-axis discharge is qy, cross is qx.
    fy = solve_interfaces_muscl(
        ex_n.z[:-1, :], ex_n.h[:-1, :], ex_n.qy[:-1, :], ex_n.qx[:-1, :],
        ex_s.z[1:, :], ex_s.h[1:, :], ex_s.qy[1:, :], ex_s.qx[1:, :],
        qy[1:-2, 1:-1], qy[2:-1, 1:-1], vs,
        qcl_cell=qx[1:-2, 1:-1], qcr_cell=qx[2:-1, 1:-1])

    sl = (slice(2, -2), slice(2, -2))
    slab_sl = (slice(1, -1), slice(1, -1))   # cells [2, M-2) in slab coords
    zc = z[sl]
    zbc = zb[sl]

    def face(fl, idx):
        return type(fl)(*(a[idx] for a in fl))

    # fx shape (M-2, Cc-3): interface k <-> cells (c, c+1) with c = k+1.
    f_e = face(fx, (slice(1, -1), slice(1, None)))
    f_w = face(fx, (slice(1, -1), slice(None, -1)))
    f_n = face(fy, (slice(1, None), slice(1, -1)))
    f_s = face(fy, (slice(None, -1), slice(1, -1)))

    # Per-cell local datum from the cell's own face-extrapolated surface
    # estimate (reference: src/Schemes/CLSchemeMUSCLHancock.clc:1156).
    zb_e, c_e = local_datum(ex_e.z[slab_sl], f_e.zbm)
    zb_w, c_w = local_datum(ex_w.z[slab_sl], f_w.zbm)
    zb_n, c_n = local_datum(ex_n.z[slab_sl], f_n.zbm)
    zb_s, c_s = local_datum(ex_s.z[slab_sl], f_s.zbm)

    inv_dx, inv_dy = 1.0 / params.dx, 1.0 / params.dy
    z_e = f_e.hr + zb_e
    z_w = f_w.hl + zb_w
    z_n = f_n.hr + zb_n
    z_s = f_s.hl + zb_s
    src_x = -C.GRAVITY * 0.5 * (z_e + z_w) * (zb_e - zb_w) * inv_dx
    src_y = -C.GRAVITY * 0.5 * (z_n + z_s) * (zb_n - zb_s) * inv_dy

    d_z = (f_e.mass - f_w.mass) * inv_dx + (f_n.mass - f_s.mass) * inv_dy
    d_qx = (((f_e.along + c_e) - (f_w.along + c_w)) * inv_dx
            + (f_n.cross - f_s.cross) * inv_dy - src_x)
    d_qy = ((f_e.cross - f_w.cross) * inv_dx
            + ((f_n.along + c_n) - (f_s.along + c_s)) * inv_dy - src_y)
    d_z = _round_small(d_z, vs)
    d_qx = _round_small(d_qx, vs)
    d_qy = _round_small(d_qy, vs)

    stop = f_e.stop_l | f_w.stop_r | f_n.stop_l | f_s.stop_r
    qx_c = jnp.where(stop, 0.0, qx[sl])
    qy_c = jnp.where(stop, 0.0, qy[sl])
    if comp is None:
        z_new = zc - dt * d_z
    else:
        comp_c = comp[sl]
        z_new, comp_new = comp_add(zc, comp_c, -(dt * d_z))
    qx_new = qx_c - dt * d_qx
    qy_new = qy_c - dt * d_qy

    if params.friction:
        qx_new, qy_new = implicit_friction(
            z_new, qx_new, qy_new, zbc, n[sl],
            jnp.maximum(dt, vs), vs)

    # Corrector order differs from the 1st-order kernel: clamp tiny depths
    # BEFORE the max-FSL update (reference:
    # src/Schemes/CLSchemeMUSCLHancock.clc:791-797).
    # Compensated runs judge dryness on the TRUE surface z + comp:
    # sub-ulp water lives entirely in the residue, and clamping on the
    # visible value alone would silently erase it.
    dry_new = ((z_new - zbc < vs) if comp is None
               else ((z_new - zbc) + comp_new < vs))
    z_new = jnp.where(dry_new, zbc, z_new)
    zmax_c = zmax[sl]
    zmax_new = jnp.where((z_new > zmax_c) & (zmax_c > -9990.0),
                         z_new, zmax_c)

    disabled = (zmax_c <= C.NODATA) | (zc == C.NODATA)
    # Reference dry-neighbourhood skip: centre by depth, neighbours by
    # max-FSL below the threshold (a reference quirk kept for parity;
    # src/Schemes/CLSchemeMUSCLHancock.clc:596-597, :633).
    dry5 = ((zc - zbc < vs)
            & (zmax[3:-1, 2:-2] < vs) & (zmax[1:-3, 2:-2] < vs)
            & (zmax[2:-2, 3:-1] < vs) & (zmax[2:-2, 1:-3] < vs))
    keep = disabled | dry5 | (dt <= 0.0)

    z_out = jnp.where(keep, zc, z_new)
    zmax_out = jnp.where(keep, zmax_c, zmax_new)
    qx_out = jnp.where(keep, qx[sl], qx_new)
    qy_out = jnp.where(keep, qy[sl], qy_new)
    if comp is None:
        return z_out, zmax_out, qx_out, qy_out
    comp_new = jnp.where(dry_new, 0.0, comp_new)
    comp_out = jnp.where(keep, comp_c, comp_new)
    return z_out, zmax_out, qx_out, qy_out, comp_out


def muscl_interior(z, zmax, qx, qy, zb, n, dt, params: SchemeParams,
                   comp=None):
    """Predictor + corrector on halo-extended arrays (radius 2): input
    (M, Cc) arrays, output the four updated (M-4, Cc-4) interior fields
    (five with ``comp``)."""
    slabs = muscl_predictor_interior(z, zmax, qx, qy, zb, dt, params)
    return muscl_corrector_interior(z, zmax, qx, qy, zb, n, slabs, dt,
                                    params, comp=comp)


def muscl_step(state: FlowState, static: DomainStatic, dt,
               params: SchemeParams, comp=None):
    """One full MUSCL-Hancock step on the whole grid (XLA backend).

    With ``comp`` returns (FlowState, comp_new); without, the FlowState."""
    z, zmax, qx, qy = (jnp.asarray(a) for a in state)
    zb, n = jnp.asarray(static.zb), jnp.asarray(static.manning)
    if comp is not None:
        comp = jnp.asarray(comp)

    out = muscl_interior(z, zmax, qx, qy, zb, n, dt, params, comp=comp)
    z_out, zmax_out, qx_out, qy_out = out[:4]

    sl = (slice(2, -2), slice(2, -2))
    new = FlowState(
        z=z.at[sl].set(z_out),
        zmax=zmax.at[sl].set(zmax_out),
        qx=qx.at[sl].set(qx_out),
        qy=qy.at[sl].set(qy_out),
    )
    if comp is None:
        return new
    return new, comp.at[sl].set(out[4])
