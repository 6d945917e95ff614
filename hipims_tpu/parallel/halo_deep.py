"""Halo-deep stepping over a device mesh ("forecast" sync).

The reference's novel multi-domain mode lets each domain free-run several
iterations between halo exchanges, bounded by the halo depth ("rollback
limit" = overlap - 1; reference: src/Domain/CDomainBase.cpp:163-174,
CSchemeGodunov.cpp:1273-1305, README.md:26-29).  The equivalent implemented
here: a ``shard_map`` window that

  1. keeps the state in a persistently halo-EXTENDED local block for the
     whole batch (only the halo strips move per window: ppermutes +
     in-place slice updates, rows then columns so the corner blocks
     transport in two hops),
  2. runs K steps per exchange window — each step invalidates one more
     halo ring, exactly the reference's shrinking halo validity, with NO
     rollback needed because the timestep is the global lock-step
     minimum (a scalar pmax of wave speeds per step, the
     analogue of MPI_Allreduce(MIN); reference:
     src/MPI/CMPIManager.cpp:837-889),
  3. returns the interior block at batch end.

Compared with per-step GSPMD halo exchange this amortises collective
latency K-fold at the cost of ~2*K*radius*(1/r + 1/c) redundant compute —
the same trade the reference makes with its overlap rows, minus the
unfinished rollback machinery (CModel.cpp:988 "code not yet ready").

Boundaries apply per device on the halo-extended local block with
``origin`` threading the block's global offset, so position-dependent
forcing (gridded georeferencing, cell scatter indices) evaluates in true
global coordinates; halo copies of forced cells receive the same forcing
their owners apply (see ops/boundaries.py module docstring).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.godunov import SchemeParams
from ..ops.timestep import TimestepParams, advance, cell_wave_speed
from ..state import DomainStatic, FlowState, StepCarry


def halo_depth(window: int, radius: int) -> int:
    """Halo depth (cells, on every side) for one exchange window.

    +1: the outermost extended ring never updates and skips boundary
    forcing, so it must sit one ring beyond the needed validity depth."""
    return window * radius + 1


def build_halo_deep_batch(mesh: Mesh, scheme, params: SchemeParams,
                          ts_params: TimestepParams,
                          boundaries: Sequence, end_time: float,
                          window: int, logical_rows: int, logical_cols: int,
                          compensated: bool = False,
                          dt_mode: str = "window",
                          dt_safety: float = 1.05):
    """Jitted runner: (state, carry, static, sync_time, comp, n_windows) ->
    (state, carry, comp), executing ``window`` steps per halo exchange.
    ``comp`` is the compensated-f32 z residue plane (or None); it is halo-
    exchanged and stepped alongside the state (see ops/compensated.py).

    ``dt_mode`` (active when window > 1, i.e. forecast sync):

    * ``"step"`` — lock-step: a global scalar pmax of wave speeds EVERY
      step (the MPI_Allreduce(MIN) analogue).  Bit-compatible with the
      per-step GSPMD path; the halo payload is amortised but the
      collective latency is not.
    * ``"window"`` (default) — the completion of the
      reference's forecast idea (free-running domains between sync
      points, CSchemeGodunov.cpp:1758-1790 proposeSyncPoint +
      CDomainBase.cpp:163-174 rollback limit): O(1) collectives per
      window.  The window's dt schedule derives from the global max wave
      speed FROZEN at the previous exchange, inflated by ``dt_safety``;
      each step runs collective-free (the time-controller clamp ladder
      still applies per step, deterministically replicated).  One pmax at
      window end yields the observed in-window max speed — it validates
      the schedule AND seeds the next window.  If speeds grew beyond the
      safety margin, the window re-runs from its saved start state with
      the corrected speed (the reference's rollback, realised: the
      halo-extended block at exchange time IS the rollback snapshot the
      reference never finished — CModel.cpp:988 "code not yet ready").
      Every accepted window is therefore rigorously CFL-valid — stronger
      than lock-step, whose dt always lags the speed by one step."""
    py, px = mesh.devices.shape
    radius = scheme.radius
    pad_r = pad_c = halo_depth(window, radius)
    step_fn = scheme.step
    simplified = ts_params.simplified_speed

    grid_spec = P("my", "mx")

    def _refresh_halos(ext):
        """Refresh the halo frame of a persistently-extended array from
        the neighbours' interiors: strip ppermutes + in-place slice
        updates (rows full-width first, then columns full-height, which
        transports the corners in two hops)."""
        er, ec = ext.shape
        r, c = er - 2 * pad_r, ec - 2 * pad_c
        dus = jax.lax.dynamic_update_slice
        if py > 1:
            up = [(i, i + 1) for i in range(py - 1)]
            down = [(i, i - 1) for i in range(1, py)]
            from_below = jax.lax.ppermute(
                jax.lax.dynamic_slice(ext, (r, 0), (pad_r, ec)),
                "my", up)
            from_above = jax.lax.ppermute(
                jax.lax.dynamic_slice(ext, (pad_r, 0), (pad_r, ec)),
                "my", down)
            ext = dus(ext, from_below, (0, 0))
            ext = dus(ext, from_above, (r + pad_r, 0))
        if px > 1:
            left = [(i, i + 1) for i in range(px - 1)]
            right = [(i, i - 1) for i in range(1, px)]
            from_left = jax.lax.ppermute(
                jax.lax.dynamic_slice(ext, (0, c), (er, pad_c)),
                "mx", left)
            from_right = jax.lax.ppermute(
                jax.lax.dynamic_slice(ext, (0, pad_c), (er, pad_c)),
                "mx", right)
            ext = dus(ext, from_left, (0, 0))
            ext = dus(ext, from_right, (0, c + pad_c))
        return ext

    def make_local_batch(n_windows: int):
        def local_batch(state, carry, static, sync_time, comp):
            z, zmax, qx, qy = state
            zb, n = static

            # Global offsets of this device's block.
            r, c = z.shape
            assert pad_r <= r and pad_c <= c, (
                f"halo pads ({pad_r}, {pad_c}) exceed the local block "
                f"({r}x{c}); shrink forecast_window or the mesh")
            oy = jax.lax.axis_index("my") * r
            ox = jax.lax.axis_index("mx") * c

            # One-time extension into a zero frame; the static fields'
            # halos are filled once (they never change), the state's are
            # refreshed in place at the top of every window.
            def ext0(a):
                frame = jnp.zeros((r + 2 * pad_r, c + 2 * pad_c), a.dtype)
                return jax.lax.dynamic_update_slice(frame, a,
                                                    (pad_r, pad_c))

            ez, ezmax, eqx, eqy = (ext0(a) for a in (z, zmax, qx, qy))
            ezb, en = _refresh_halos(ext0(zb)), _refresh_halos(ext0(n))
            ecomp = ext0(comp) if compensated else None

            # Static-ring + out-of-domain mask on the extended block
            # (global index space; zero-filled out-of-mesh halos land
            # outside too).
            er, ec = ez.shape
            gy = jax.lax.broadcasted_iota(jnp.int32, (er, ec), 0) \
                + (oy - pad_r)
            gx = jax.lax.broadcasted_iota(jnp.int32, (er, ec), 1) \
                + (ox - pad_c)
            ring = ((gy < radius) | (gy >= logical_rows - radius)
                    | (gx < radius) | (gx >= logical_cols - radius))

            estatic = DomainStatic(ezb, en)
            own = ((gy >= oy) & (gy < oy + r)
                   & (gx >= ox) & (gx < ox + c))

            def owned_max_speed(st):
                """Max wave speed over this device's owned cells."""
                spd = cell_wave_speed(st.z, st.zmax, st.qx, st.qy, ezb,
                                      params.quite_small, simplified)
                return jnp.max(jnp.where(own, spd, 0.0))

            def pmax2(v):
                return jax.lax.pmax(jax.lax.pmax(v, "my"), "mx")

            def one_step(st, cr, cm):
                """Boundaries + scheme step on the extended block; returns
                (new_state, local_max_speed, new_comp) with NO collective
                and NO time-controller advance."""
                # Boundaries on the extended block (halo copies get the
                # same forcing their owners apply); position-dependent
                # forcing evaluates in global coordinates via the block
                # origin, and the mask (~ring: inside the logical grid,
                # off the static ghost ring) bounds the forced cells to
                # exactly the set every other execution path forces.
                bdy_origin = (oy - pad_r, ox - pad_c)
                allowed = ~ring
                for b in boundaries:
                    if compensated:
                        st, cm = b.apply(st, estatic, cr.t, cr.dt,
                                         cr.t_hydro, params, comp=cm,
                                         origin=bdy_origin, mask=allowed)
                    else:
                        st = b.apply(st, estatic, cr.t, cr.dt, cr.t_hydro,
                                     params, origin=bdy_origin,
                                     mask=allowed)

                if compensated:
                    new, cm_new = step_fn(st, estatic, cr.dt, params,
                                          comp=cm)
                    cm_new = jnp.where(ring, cm, cm_new)
                else:
                    new = step_fn(st, estatic, cr.dt, params)
                    cm_new = None
                new = FlowState(*(jnp.where(ring, o, v)
                                  for o, v in zip(st, new)))
                return new, owned_max_speed(new), cm_new

            def step_body(sc, _):
                """Lock-step: pmax + controller advance EVERY step (the
                MPI_Allreduce(MIN) analogue)."""
                st, cr, cm = sc
                new, local_max, cm_new = one_step(st, cr, cm)
                gmax = pmax2(local_max)
                cr = advance(cr, gmax, sync_time, end_time, params.dx,
                             ts_params)
                return (new, cr, cm_new), None

            # Amortised dt requires a CFL-driven controller: in fixed-dt
            # mode advance() ignores the speed entirely, and the
            # validation/rollback would wrongly clamp the user's fixed dt
            # by a CFL law they opted out of.
            amortise = (dt_mode == "window" and window > 1
                        and ts_params.dynamic)

            def run_frozen_window(est, cr, cm, g):
                """K collective-free steps on the frozen speed ``g`` (dt =
                clamp ladder fed with g*dt_safety), then ONE pmax of the
                in-window observed max speed."""
                def stepF(sc, _):
                    st, c, m, smax = sc
                    new, local_max, m_new = one_step(st, c, m)
                    c = advance(c, g * dt_safety, sync_time, end_time,
                                params.dx, ts_params)
                    return (new, c, m_new,
                            jnp.maximum(smax, local_max)), None
                (est, cr, cm, smax), _ = jax.lax.scan(
                    stepF, (est, cr, cm, jnp.zeros_like(g)), length=window)
                return est, cr, cm, pmax2(smax)

            def window_body(wc, _):
                est, cr, cm, gmax = wc
                est = FlowState(*(_refresh_halos(a) for a in est))
                if compensated:
                    cm = _refresh_halos(cm)
                if not amortise:
                    (est, cr, cm), _ = jax.lax.scan(
                        step_body, (est, cr, cm), length=window)
                    return (est, cr, cm, gmax), None

                saved = (est, cr, cm)
                est, cr, cm, gobs = run_frozen_window(est, cr, cm, gmax)

                # Validation + rollback re-run: the window's dts came from
                # gmax*dt_safety, so they are rigorously CFL-valid iff the
                # observed speed stayed within the margin.  Replicated
                # predicate -> identical trip count on every device.  The
                # retry cap is a divergence backstop (speeds are
                # physically bounded; >2 trips is already rare).
                def violated(val):
                    _e, _c, _m, g, gob, it = val
                    # ~(<=) instead of (>): a NaN observed speed (a
                    # window so over-dt that the state overflowed) MUST
                    # count as violated — it is the very case the
                    # rollback exists for.
                    return ~(gob <= g * dt_safety) & (it < 4)

                def rerun(val):
                    _e, _c, _m, g, gob, it = val
                    # Non-finite observed speed carries no usable value;
                    # halve the dt per retry instead (the snapshot is
                    # clean, only the schedule was wrong).
                    g_new = jnp.where(jnp.isfinite(gob), gob, g * 2.0)
                    e0, c0, m0 = saved
                    # The carried-in dt was derived from the stale speed;
                    # cap it too (preserving the negative-dt suspension
                    # and the sync-landing value, which is only ever
                    # smaller).
                    dt_cap = ts_params.courant * params.dx \
                        / (g_new * dt_safety)
                    c0 = c0._replace(dt=jnp.where(
                        c0.dt > 0.0, jnp.minimum(c0.dt, dt_cap), c0.dt))
                    e1, c1, m1, gob1 = run_frozen_window(e0, c0, m0, g_new)
                    return e1, c1, m1, g_new, gob1, it + 1

                est, cr, cm, gmax, gobs, _ = jax.lax.while_loop(
                    violated, rerun, (est, cr, cm, gmax, gobs,
                                      jnp.zeros((), jnp.int32)))
                # The observed max seeds the next window's frozen speed.
                return (est, cr, cm, gobs), None

            est = FlowState(ez, ezmax, eqx, eqy)
            if amortise:
                # One collective seeds the first window's frozen speed.
                gmax0 = pmax2(owned_max_speed(est))
            else:
                gmax0 = jnp.zeros((), ez.dtype)
            (est, carry, ecomp, _), _ = jax.lax.scan(
                window_body, (est, carry, ecomp, gmax0), length=n_windows)

            interior = (slice(pad_r, pad_r + r), slice(pad_c, pad_c + c))
            out_comp = ecomp[interior] if compensated else comp
            return tuple(a[interior] for a in est), carry, out_comp

        return local_batch

    comp_spec = grid_spec if compensated else P()

    def _shard(fn):
        # check_vma=False: the window scans carry replicated values (the
        # pmax-ed speed, the time carry) beside per-device blocks, which
        # the varying-across-mesh type check rejects as scan carries.
        return jax.shard_map(
            fn, mesh=mesh, check_vma=False,
            in_specs=((grid_spec,) * 4, P(), (grid_spec, grid_spec), P(),
                      comp_spec),
            out_specs=((grid_spec,) * 4, P(), comp_spec))

    @partial(jax.jit, static_argnames=("n_steps",),
             donate_argnames=("state", "carry", "comp"))
    def run_batch(state: FlowState, carry: StepCarry, static: DomainStatic,
                  sync_time, comp, n_steps: int):
        # n_steps counts exchange windows here (window steps each).  The
        # whole batch runs inside ONE shard_map: the state stays in its
        # halo-extended form across windows (only the halo strips move
        # per window) and the window/step loops are scans, so the
        # compiled graph is one-step sized regardless of the batch.
        st, carry, comp = _shard(make_local_batch(n_steps))(
            tuple(state), carry, tuple(static), sync_time, comp)
        # NaN/Inf probe, as in Simulation._build_run_batch: divergence
        # poisons the batch statistic the host reads back.
        poison = 0.0 * jnp.sum(st[0])
        carry = carry._replace(batch_dt_total=carry.batch_dt_total + poison)
        return FlowState(*st), carry, comp

    return run_batch
