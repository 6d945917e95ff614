"""First-order step + CFL partial as one GPU kernel (Pallas through Triton).

The XLA step materialises interface planes between its fusions, writes the
interior back with ``.at[sl].set`` and re-reads the new state for the CFL
reduction.  This kernel does the whole first-order step (Godunov or
partial-inertial) in one pass: each block of a 2-D grid loads the centre
and the four neighbour views it needs (the halo comes through L1/L2), runs
the per-cell update, writes the 4 planes (5 with the compensated-f32
residue) once, and writes one CFL partial max per block, reduced by a
``jnp.max`` outside the kernel.

The layout follows the reference's GPU kernels rather than the TPU row
tiles: one work-item per cell, every cell solving all four of its faces
(each interface is therefore solved by both of its cells, as in
gts_cacheDisabled, src/Schemes/CLSchemeGodunov.clc:164-384), neighbours
read through the cache.  Blocks run in any order and share nothing.

Numerics are the XLA path's: the kernel body calls the same elementwise
pieces (``solve_interfaces``, ``godunov_cell_update``, ``face_discharge``,
``inertial_cell_update``, ``cell_wave_speed``).  The static ring (one cell)
and the ragged grid edges are masked by global index, so any grid shape
works without padding.  Neighbour loads use clamped indices (always in
bounds; a clamped value only ever feeds a masked ring cell); stores are
masked windows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..state import DomainStatic, FlowState
from .godunov import SchemeParams, godunov_cell_update
from .inertial import face_discharge, inertial_cell_update
from .riemann import solve_interfaces
from .timestep import cell_wave_speed

SCHEMES = ("godunov", "inertial")

# (rows, cols) of one block and warps per block.  Powers of two; chosen on
# the card (see PERF.md).
BLOCK = (8, 64)
NUM_WARPS = 4


def supports(scheme: str, dtype) -> bool:
    """True when the kernel implements this scheme at this state dtype."""
    return scheme in SCHEMES and jnp.dtype(dtype) == jnp.float32


def _kernel(dt_ref, z_ref, zmax_ref, qx_ref, qy_ref, zb_ref, n_ref, *refs,
            scheme: str, params: SchemeParams, simplified: bool,
            rows: int, cols: int, block, compensated: bool):
    if compensated:
        comp_ref, *refs = refs
    outs, speed_ref = refs[:-1], refs[-1]
    br, bc = block
    bi, bj = pl.program_id(0), pl.program_id(1)
    r0, c0 = bi * br, bj * bc
    ri = r0 + jnp.arange(br, dtype=jnp.int32)[:, None]
    ci = c0 + jnp.arange(bc, dtype=jnp.int32)[None, :]
    inside = (ri < rows) & (ci < cols)
    ring = (ri < 1) | (ri >= rows - 1) | (ci < 1) | (ci >= cols - 1)

    # Clamped row/col indices of the centre and its neighbours.
    rr = {d: jnp.clip(ri + d, 0, rows - 1) for d in (-1, 0, 1)}
    cc = {d: jnp.clip(ci + d, 0, cols - 1) for d in (-1, 0, 1)}

    def view(ref, dr=0, dc=0):
        return ref[rr[dr], cc[dc]]

    dt = dt_ref[0]
    vs = params.very_small
    zc, zbc = view(z_ref), view(zb_ref)
    qxc, qyc = view(qx_ref), view(qy_ref)
    zmaxc, nc = view(zmax_ref), view(n_ref)
    compc = view(comp_ref) if compensated else None
    # North = +row, east = +col (ops/godunov.py orientation).
    nbr = {k: (view(z_ref, dr, dc), view(zb_ref, dr, dc))
           for k, (dr, dc) in dict(n=(1, 0), s=(-1, 0), e=(0, 1),
                                   w=(0, -1)).items()}
    dry5 = (zc - zbc) < vs
    for zv, zbv in nbr.values():
        dry5 = dry5 & ((zv - zbv) < vs)

    if scheme == "godunov":
        qx_e, qy_e = view(qx_ref, 0, 1), view(qy_ref, 0, 1)
        qx_w, qy_w = view(qx_ref, 0, -1), view(qy_ref, 0, -1)
        qx_n, qy_n = view(qx_ref, 1, 0), view(qy_ref, 1, 0)
        qx_s, qy_s = view(qx_ref, -1, 0), view(qy_ref, -1, 0)
        (z_e, zb_e), (z_w, zb_w) = nbr["e"], nbr["w"]
        (z_n, zb_n), (z_s, zb_s) = nbr["n"], nbr["s"]
        f_e = solve_interfaces(zc, zbc, qxc, qyc, z_e, zb_e, qx_e, qy_e, vs)
        f_w = solve_interfaces(z_w, zb_w, qx_w, qy_w, zc, zbc, qxc, qyc, vs)
        f_n = solve_interfaces(zc, zbc, qyc, qxc, z_n, zb_n, qy_n, qx_n, vs)
        f_s = solve_interfaces(z_s, zb_s, qy_s, qx_s, zc, zbc, qyc, qxc, vs)
        new = godunov_cell_update(zc, zmaxc, qxc, qyc, zbc, nc,
                                  f_e, f_w, f_n, f_s, dry5, dt, params,
                                  comp_c=compc)
    else:
        (z_e, zb_e), (z_w, zb_w) = nbr["e"], nbr["w"]
        (z_n, zb_n), (z_s, zb_s) = nbr["n"], nbr["s"]
        dx = params.dx
        q_e = face_discharge(nc, dt, view(qx_ref, 0, 1), z_e, zb_e,
                             zc, zbc, dx, vs)
        q_w = face_discharge(nc, dt, qxc, zc, zbc, z_w, zb_w, dx, vs)
        q_n = face_discharge(nc, dt, view(qy_ref, 1, 0), z_n, zb_n,
                             zc, zbc, dx, vs)
        q_s = face_discharge(nc, dt, qyc, zc, zbc, z_s, zb_s, dx, vs)
        new = inertial_cell_update(zc, zmaxc, qxc, qyc, zbc,
                                   q_e, q_w, q_n, q_s, dry5, dt, params,
                                   comp_c=compc)

    old = (zc, zmaxc, qxc, qyc) + ((compc,) if compensated else ())
    new = tuple(jnp.where(ring, o, v) for o, v in zip(old, new))
    window = (pl.ds(r0, br), pl.ds(c0, bc))
    for ref, val in zip(outs, new):
        plgpu.store(ref.at[window], val, mask=inside)

    spd = cell_wave_speed(new[0], new[1], new[2], new[3], zbc,
                          params.quite_small, simplified)
    speed_ref[bi, bj] = jnp.max(jnp.where(inside, spd, 0.0))


@functools.partial(jax.jit, static_argnames=(
    "scheme", "params", "simplified", "block", "num_warps", "interpret"))
def triton_step(scheme: str, state: FlowState, static: DomainStatic, dt,
                params: SchemeParams, simplified: bool = False, comp=None,
                block=BLOCK, num_warps: int = NUM_WARPS,
                interpret: bool = False):
    """One first-order step + CFL reduce.  Returns (new_state, max_speed),
    or (new_state, max_speed, comp_new) when ``comp`` (the
    compensated-f32 z residue plane) is given.  ``interpret`` runs the
    kernel through the Pallas interpreter (tests on the CPU)."""
    if scheme not in SCHEMES:
        raise ValueError(f"no GPU kernel for scheme {scheme!r}")
    rows, cols = state.z.shape
    dtype = state.z.dtype
    compensated = comp is not None
    grid = (pl.cdiv(rows, block[0]), pl.cdiv(cols, block[1]))
    n_out = 5 if compensated else 4
    kernel = functools.partial(
        _kernel, scheme=scheme, params=params, simplified=simplified,
        rows=rows, cols=cols, block=tuple(block), compensated=compensated)
    inputs = [jnp.reshape(jnp.asarray(dt, dtype), (1,)), *state,
              static.zb, static.manning]
    if compensated:
        inputs.append(comp)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    outs = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[any_spec] * len(inputs),
        out_specs=[any_spec] * (n_out + 1),
        out_shape=[jax.ShapeDtypeStruct((rows, cols), dtype)] * n_out
        + [jax.ShapeDtypeStruct(grid, dtype)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name=f"{scheme}_step",
    )(*inputs)
    new = FlowState(*outs[:4])
    speed = jnp.max(outs[-1])
    if compensated:
        return new, speed, outs[4]
    return new, speed
