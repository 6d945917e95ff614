"""Depth-positivity-preserving interface reconstruction + HLLC flux, vectorised
over all interfaces of one axis at once.

Design note: the reference evaluates every interface twice, once
from each adjacent cell, with a per-cell vertical datum shift
(reference: src/Schemes/CLSchemeGodunov.clc:27-159 reconstructInterface;
src/Solvers/CLSolverHLLC.clc:27-248 riemannSolver).  The shift ``s`` lowers
both the reconstructed surface ``z`` and the local bed ``zb`` by the same
amount, and algebra shows it changes the momentum-pressure flux by an
additive constant

    C = -0.5 * g * zb_local^2,   zb_local = zb_max - s = min(zb_max, z_cell)

identical for the left flux, the right flux, the HLLC middle-state flux and
the both-dry flux, while the mass flux, wave speeds and branch selection are
shift-invariant.  (Derivation: the pressure term 0.5 g (z'^2 - 2 zb' z')
with z' = h + zb' equals 0.5 g h^2 - 0.5 g zb'^2.)  We therefore solve each
Riemann problem ONCE per interface keeping only the shift-invariant
0.5 g h^2 pressure part, and let the per-cell update add C — exactly
reproducing the reference's per-cell answer with half the flux work.
Crucially, every quantity stays at local-terrain magnitude: evaluating the
shifted fluxes naively and correcting afterwards would catastrophically
cancel at closed-wall cells (bed 9999.9), where the uncorrected pressure
terms reach ~5e8.

All inputs are arrays over interfaces; "along" denotes the axis normal to the
interface, "cross" the tangential axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..constants import GRAVITY


class InterfaceFlux(NamedTuple):
    """Shared (shift-free) interface solution.

    mass:    flux of z (volume)                 -- shift-invariant
    along:   flux of along-axis discharge with the 0.5 g h^2 pressure part
             only; each cell adds its datum term C = -0.5 g zb_local^2
    cross:   flux of cross-axis discharge       -- shift-invariant
    zbm:     max bed elevation at the interface (pre-shift local datum)
    hl, hr:  reconstructed depths either side (shift-invariant)
    stop_l:  wet/dry stopping condition seen by the left cell
    stop_r:  wet/dry stopping condition seen by the right cell
    """

    mass: jax.Array
    along: jax.Array
    cross: jax.Array
    zbm: jax.Array
    hl: jax.Array
    hr: jax.Array
    stop_l: jax.Array
    stop_r: jax.Array


def solve_interfaces(zl, zbl, qal, qcl, zr, zbr, qar, qcr,
                     very_small: float) -> InterfaceFlux:
    """Reconstruct + HLLC for a batch of interfaces (first-order data).

    Semantics mirror reconstructInterface
    (src/Schemes/CLSchemeGodunov.clc:27-159) and riemannSolver
    (src/Solvers/CLSolverHLLC.clc:27-248) with the datum shift factored out.
    """
    vs = very_small

    # Raw depths and velocities (velocity zeroed below the dry threshold, as
    # in the reference's pre-reconstruction step).  One reciprocal per side
    # serves both components — division is the costly op here.
    hl_raw = zl - zbl
    hr_raw = zr - zbr
    inv_hl = jnp.where(hl_raw < vs, 0.0,
                       1.0 / jnp.where(hl_raw < vs, 1.0, hl_raw))
    inv_hr = jnp.where(hr_raw < vs, 0.0,
                       1.0 / jnp.where(hr_raw < vs, 1.0, hr_raw))
    ual = qal * inv_hl
    ucl = qcl * inv_hl
    uar = qar * inv_hr
    ucr = qcr * inv_hr

    # Non-negative reconstruction against the common (max) bed.
    zbm = jnp.maximum(zbl, zbr)
    hl = jnp.maximum(zl - zbm, 0.0)
    hr = jnp.maximum(zr - zbm, 0.0)
    qal_r = hl * ual
    qcl_r = hl * ucl
    qar_r = hr * uar
    qcr_r = hr * ucr

    return _hllc(hl, hr, zbm, qal_r, qcl_r, qar_r, qcr_r,
                 ual, ucl, uar, ucr, qal, qar, vs,
                 qcl_raw=qcl, qcr_raw=qcr)


def solve_interfaces_muscl(zl_e, hl_e, qal_e, qcl_e,
                           zr_e, hr_e, qar_e, qcr_e,
                           qal_cell, qar_cell,
                           very_small: float,
                           qcl_cell=None, qcr_cell=None) -> InterfaceFlux:
    """Reconstruct + HLLC for MUSCL face-extrapolated estimates.

    Mirrors the corrector-stage reconstructInterface overload
    (src/Schemes/CLSchemeMUSCLHancock.clc:1119-1230): each side supplies an
    extrapolated (z, h, qx, qy) estimate whose implied bed is z - h; the
    stopping conditions still consult the raw cell discharges
    (qal_cell / qar_cell).
    """
    vs = very_small

    inv_hl = jnp.where(hl_e <= vs, 0.0,
                       1.0 / jnp.where(hl_e <= vs, 1.0, hl_e))
    inv_hr = jnp.where(hr_e <= vs, 0.0,
                       1.0 / jnp.where(hr_e <= vs, 1.0, hr_e))
    ual = qal_e * inv_hl
    ucl = qcl_e * inv_hl
    uar = qar_e * inv_hr
    ucr = qcr_e * inv_hr

    zbm = jnp.maximum(zl_e - hl_e, zr_e - hr_e)
    hl = jnp.maximum(zl_e - zbm, 0.0)
    hr = jnp.maximum(zr_e - zbm, 0.0)
    qal_r = hl * ual
    qcl_r = hl * ucl
    qar_r = hr * uar
    qcr_r = hr * ucr

    return _hllc(hl, hr, zbm, qal_r, qcl_r, qar_r, qcr_r,
                 ual, ucl, uar, ucr, qal_cell, qar_cell, vs,
                 qcl_raw=qcl_cell, qcr_raw=qcr_cell)


def _hllc(hl, hr, zbm, qal_r, qcl_r, qar_r, qcr_r,
          ual, ucl, uar, ucr, qal_raw, qar_raw, vs,
          qcl_raw=None, qcr_raw=None) -> InterfaceFlux:
    """Shared HLLC core on reconstructed states (depth form; the per-cell
    datum term -0.5 g zb_local^2 is added by the caller)."""
    g = GRAVITY

    # Stopping conditions ("prevent draining from a dry cell").  The two
    # interface-shared conditions plus each side's own outflow condition;
    # shift-invariant so identical from either adjacent cell's perspective.
    # Single precision guards every comparison against rounding noise with
    # an absolute floor AND a tangential-relative floor (the reference's
    # strict 0.0 comparisons, CLSchemeGodunov.clc:105-133, zero the cell's
    # whole discharge for ~ulp ghost velocities pointing at walls — see
    # constants.STOP_FLOW_EPS/STOP_FLOW_REL).  f64 keeps exact
    # reference/oracle parity (all thresholds collapse to 0.0).
    dry_l = hl <= vs
    dry_r = hr <= vs
    if hl.dtype == jnp.float32:
        eps, rel = C.STOP_FLOW_EPS, C.STOP_FLOW_REL
        thr_ul = jnp.maximum(eps, rel * jnp.abs(ucl))
        thr_ur = jnp.maximum(eps, rel * jnp.abs(ucr))
        # Raw-discharge conditions scale by the same side's raw cross
        # discharge when the caller can supply it (the noise source).
        thr_ql = (jnp.maximum(eps, rel * jnp.abs(qcl_raw))
                  if qcl_raw is not None else eps)
        thr_qr = (jnp.maximum(eps, rel * jnp.abs(qcr_raw))
                  if qcr_raw is not None else eps)
    else:
        thr_ul = thr_ur = thr_ql = thr_qr = 0.0
    cond_shared = (dry_r & (ual < -thr_ul)) | (dry_l & (uar > thr_ur))
    stop_l = (dry_l & (qal_raw > thr_ql)) | cond_shared
    stop_r = (dry_r & (qar_raw < -thr_qr)) | cond_shared

    # Velocities recomputed on reconstructed depths (strict < as in HLLC).
    vl = jnp.where(hl < vs, 0.0, ual)
    wl = jnp.where(hl < vs, 0.0, ucl)
    vr = jnp.where(hr < vs, 0.0, uar)
    wr = jnp.where(hr < vs, 0.0, ucr)

    al = jnp.sqrt(g * hl)
    ar = jnp.sqrt(g * hr)
    # a_star = sqrt(g * h_star) with h_star = (a_avg + (vl-vr)/4)^2 / g
    # collapses to |a_avg + (vl-vr)/4| — no square, division or sqrt.
    a_avg = 0.5 * (al + ar)
    u_star = 0.5 * (vl + vr) + al - ar
    a_star = jnp.abs(a_avg + 0.25 * (vl - vr))

    s_l = jnp.where(hl < vs, vr - 2.0 * ar,
                    jnp.minimum(vl - al, u_star - a_star))
    s_r = jnp.where(hr < vs, vl + 2.0 * al,
                    jnp.maximum(vr + ar, u_star + a_star))
    mom_r = hr * (vr - s_r)
    mom_l = hl * (vl - s_l)
    # The middle wave speed s_m = (s_l*mom_r - s_r*mom_l)/(mom_r - mom_l)
    # is consumed ONLY as the branch predicate s_m >= 0 below, so the
    # division reduces to a sign agreement test (a division costs several
    # arithmetic ops; the selection is bit-identical, including the
    # den == 0 fallback s_m = 0 which satisfies >= 0).
    sm_num = s_l * mom_r - s_r * mom_l
    sm_den = mom_r - mom_l
    # Pure boolean algebra, no bool-valued select.
    sm_nonneg = (((sm_den > 0.0) & (sm_num >= 0.0))
                 | ((sm_den < 0.0) & (sm_num <= 0.0))
                 | (sm_den == 0.0))

    # Shift-invariant pressure part: 0.5 g h^2 (the datum term
    # -0.5 g zb_local^2 is per-cell and added at assembly).
    p_l = 0.5 * g * hl * hl
    p_r = 0.5 * g * hr * hr

    fl_mass = qal_r
    fl_along = vl * qal_r + p_l
    fl_cross = vl * qcl_r
    fr_mass = qar_r
    fr_along = vr * qar_r + p_r
    fr_cross = vr * qcr_r

    sdiff = s_r - s_l
    inv_sdiff = jnp.where(sdiff == 0.0, 0.0,
                          1.0 / jnp.where(sdiff == 0.0, 1.0, sdiff))
    slsr = s_l * s_r
    f1_m = (s_r * fl_mass - s_l * fr_mass + slsr * (hr - hl)) * inv_sdiff
    f2_m = (s_r * fl_along - s_l * fr_along
            + slsr * (fr_mass - fl_mass)) * inv_sdiff

    b_left = s_l >= 0.0
    b_right = (s_l < 0.0) & (s_r < 0.0)
    b_mid1 = (s_l < 0.0) & (s_r >= 0.0) & sm_nonneg
    # middle-2 = remaining case; cross flux advected with the right velocity.

    mass = jnp.where(b_left, fl_mass,
                     jnp.where(b_right, fr_mass, f1_m))
    along = jnp.where(b_left, fl_along,
                      jnp.where(b_right, fr_along, f2_m))
    cross = jnp.where(b_left, fl_cross,
                      jnp.where(b_right, fr_cross,
                                jnp.where(b_mid1, f1_m * wl, f1_m * wr)))

    # Both sides dry: hydrostatic pressure only.  The reference expression
    # 0.5 g (((zl+zr)/2)^2 - zbm (zl+zr)) equals 0.25 g (hl+hr)^2 / 2
    # - 0.5 g zbm^2; the datum part is again the per-cell C term.
    both_dry = (hl < vs) & (hr < vs)
    hsum = hl + hr
    dry_along = 0.5 * g * 0.25 * hsum * hsum
    mass = jnp.where(both_dry, 0.0, mass)
    along = jnp.where(both_dry, dry_along, along)
    cross = jnp.where(both_dry, 0.0, cross)

    return InterfaceFlux(mass=mass, along=along, cross=cross, zbm=zbm,
                         hl=hl, hr=hr, stop_l=stop_l, stop_r=stop_r)


def local_datum(z_cell, zbm):
    """Per-cell local datum and its additive momentum-flux term.

    zb_local = zb_max - shift = min(zb_max, z_cell);
    C = -0.5 g zb_local^2.  Adding C to the shared depth-form ``along``
    flux reproduces the reference's shifted-datum flux exactly (see module
    docstring) with every term at local-terrain magnitude.
    Returns (zb_local, C).
    """
    zb_local = jnp.minimum(zbm, z_cell)
    c = -0.5 * GRAVITY * zb_local * zb_local
    return zb_local, c
