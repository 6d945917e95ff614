"""Simulation master loop — the equivalent of the reference's CModel.

The reference drives each domain with a persistent worker thread queueing
batches of kernel launches, suspends devices at sync points via the
negative-timestep trick, and polls busy flags from a host spin loop
(reference: src/CModel.cpp:1041-1139 runModelMain;
src/Schemes/CSchemeGodunov.cpp:1147-1369 Threaded_runBatch).

Here a batch is a single jitted ``lax.scan`` of K steps: boundaries ->
scheme step -> CFL reduce -> time controller, with the same negative-dt
suspension making overshooting steps idle.  The host loop only reads back
three scalars per batch (t, dt, counters), mirroring the reference's
readKeyStatistics, and sizes the next batch toward a wall-clock target
exactly like the reference's adaptive queue
(src/Schemes/CSchemeGodunov.cpp:1419-1448).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..domain import Domain
from ..models import Scheme, get_scheme
from ..ops.boundaries import apply_boundaries, interior_force_mask
from ..ops.godunov import SchemeParams
from ..ops.timestep import TimestepParams, advance, max_wave_speed
from ..state import DomainStatic, FlowState, StepCarry, initial_carry


@dataclasses.dataclass
class SimulationConfig:
    """Run configuration (reference: <simulation> parameters,
    src/CModel.cpp:65-133, and per-scheme <parameter>s,
    src/Schemes/CSchemeGodunov.cpp:113-338)."""

    scheme: str = "godunov"
    duration: float = 3600.0
    output_frequency: float = 600.0
    courant: float = 0.5
    initial_timestep: float = 0.01
    timestep_mode: str = "cfl"          # "cfl" | "fixed"
    fixed_timestep: float = 0.1
    friction: bool = True
    dry_threshold: float = C.VERY_SMALL
    dtype: str = "float64"              # "float32" | "float64" | "float32c"
                                        # float32c = f32 state + Neumaier-
                                        # compensated z accumulation
                                        # (see ops/compensated.py)
    batch_size: int = 64                # steps per device round-trip
    batch_auto: bool = True             # adapt batch toward target seconds
    batch_target_seconds: float = 0.5
    sync_tolerance: float = 1e-5        # output-time match tolerance
    kernel_backend: str = "auto"        # "auto" | "xla" | "triton"
    sync_method: str = "timestep"       # mesh mode: "timestep" (per-step
                                        # GSPMD halos) | "forecast"
                                        # (halo-deep windows)
    forecast_window: int = 8            # steps per exchange in forecast
    forecast_dt: str = "window"         # forecast dt discipline:
                                        # "window" (frozen speed + one
                                        # pmax per window + rollback
                                        # revalidation — O(1) collectives
                                        # per window, the reference's
                                        # free-running forecast completed)
                                        # | "step"
                                        # (lock-step pmax every step)
    forecast_dt_safety: float = 1.05    # frozen-speed inflation margin
    io_mode: str = "auto"               # output/checkpoint gathering:
                                        # "gather" (full grid on every
                                        # host) | "stream" (bounded row
                                        # chunks; runtime/sharded_io.py)
                                        # | "auto" (stream above
                                        # io_stream_cells)
    io_stream_cells: int = 16_000_000   # auto threshold (cells)
    io_chunk_mb: int = 64               # host-memory budget per chunk set


class _OutputSnapshot:
    """One output event's host-side view of the simulation.

    Built on EVERY process before any rank-gated file write: accessing
    ``state_logical``/``static_logical`` on a multi-process sharded array
    is a global collective (process_allgather), so the gathers must run
    symmetrically on all ranks — gating the whole writer on rank 0 would
    deadlock the cluster at the first output (the reference gathers on
    every node and gates only the write, src/main.cpp:561-578).  The
    snapshot caches the gathered arrays so a writer touching them several
    times costs one gather set, and delegates everything else to the
    simulation."""

    streaming = False

    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self.write_files = sim.write_outputs
        fetch = sim._fetch_global
        lr, lc = sim.domain.logical_rows, sim.domain.logical_cols
        # Full gathered arrays — shared with save_checkpoint so
        # a --checkpoint run pays ONE gather set per output event.  The
        # static fields never change, so their gather is cached across
        # events on the simulation.
        self.state_full = FlowState(*(fetch(a) for a in sim.state))
        if sim._static_full_cache is None:
            sim._static_full_cache = DomainStatic(*(fetch(a)
                                                    for a in sim.static))
        self.static_full = sim._static_full_cache
        self.comp_full = (fetch(sim.comp)
                          if getattr(sim, "comp", None) is not None
                          else None)
        self.state_logical = FlowState(*(a[:lr, :lc]
                                         for a in self.state_full))
        self.static_logical = DomainStatic(*(a[:lr, :lc]
                                             for a in self.static_full))

    def __getattr__(self, name):
        if name == "_sim":
            # Guard: without it a lookup before __init__ finishes (or a
            # pickling probe) recurses through __getattr__ forever.
            raise AttributeError(name)
        return getattr(self._sim, name)


class _StreamingSnapshot:
    """One output event's BOUNDED-memory view: no full-grid gather
    anywhere (runtime/sharded_io.py; the reference's per-domain writes,
    src/Domain/Cartesian/CDomainCartesian.cpp:804-829, never gather
    either).  Chunk iteration is collective — in multi-process runs EVERY
    rank must drive the writers, with file writes gated on
    ``write_files``."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self.write_files = sim.write_outputs
        self.streaming = True
        cols = sim.domain.logical_cols
        # 6 f32 planes move per chunk set (4 state + 2 static).
        self.chunk_rows = _sharded_io().chunk_rows_for(
            cols, n_fields=6, budget_mb=sim.config.io_chunk_mb)

    def stream_chunks(self, reverse=False):
        """Yield (row0, FlowState chunk, DomainStatic chunk) host arrays
        over the LOGICAL grid, bounded by chunk_rows.
        ``reverse=True`` iterates north-first for raster writers."""
        sim = self._sim
        lr, lc = sim.domain.logical_rows, sim.domain.logical_cols
        stream = _sharded_io().stream_global_rows
        its = [stream(a, self.chunk_rows, reverse=reverse)
               for a in (*sim.state, *sim.static)]
        for parts in zip(*its):
            r0 = parts[0][0]
            if r0 >= lr:
                continue
            n = min(parts[0][1].shape[0], lr - r0)
            arrs = [p[1][:n, :lc] for p in parts]
            yield r0, FlowState(*arrs[:4]), DomainStatic(*arrs[4:])

    def sample_cells(self, rows, cols):
        """(FlowState, DomainStatic) of the listed cells as (K,) host
        arrays — a tiny device-side gather, replicated to every process
        (for gauge writers)."""
        import jax.numpy as jnp
        sim = self._sim
        ri = jnp.asarray(rows, jnp.int32)
        ci = jnp.asarray(cols, jnp.int32)
        st, sc = _pick_cells(tuple(sim.state), tuple(sim.static), ri, ci)
        fetch = sim._fetch_global
        return (FlowState(*(fetch(a) for a in st)),
                DomainStatic(*(fetch(a) for a in sc)))

    def volume_device(self) -> float:
        """Domain water volume via an on-device reduction (replicated
        scalar; no gather)."""
        sim = self._sim
        v = _device_volume(sim.state.z, sim.state.zmax, sim.static.zb,
                           sim.domain.logical_rows, sim.domain.logical_cols)
        return float(v) * sim.domain.dx * sim.domain.dy

    def __getattr__(self, name):
        if name == "_sim":
            raise AttributeError(name)
        if name in ("state_logical", "static_logical", "state_full",
                    "static_full", "comp_full"):
            raise AttributeError(
                f"{name} is unavailable on a streaming output snapshot "
                "(io_mode='stream'): it would materialise the full grid "
                "on every host. Use stream_chunks()/sample_cells()/"
                "volume_device(), or set io_mode='gather'.")
        return getattr(self._sim, name)


def _sharded_io():
    from . import sharded_io
    return sharded_io


@jax.jit
def _pick_cells(state, static, ri, ci):
    return ([a[ri, ci] for a in state], [a[ri, ci] for a in static])


@partial(jax.jit, static_argnums=(3, 4))
def _device_volume(z, zmax, zb, lr, lc):
    gy = jax.lax.broadcasted_iota(jnp.int32, z.shape, 0)
    gx = jax.lax.broadcasted_iota(jnp.int32, z.shape, 1)
    h = jnp.maximum(z - zb, 0.0)
    keep = (zmax > C.NODATA) & (gy < lr) & (gx < lc)
    # f64 accumulation of the f32 planes (the x64 flag is on in f64 runs;
    # in f32 runs promotion still happens on CPU hosts with x64 enabled —
    # harmless for a diagnostic scalar).
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return jnp.sum(jnp.where(keep, h, 0.0), dtype=acc)


class Simulation:
    """Single-domain simulation driver."""

    def __init__(self, domain: Domain, config: SimulationConfig,
                 boundaries: Sequence = (),
                 output_writer: Optional[Callable] = None,
                 mesh=None):
        self.domain = domain
        self.config = config
        self.boundaries = tuple(boundaries)
        self.output_writer = output_writer
        # Multi-host: every process runs the output path (its gathers are
        # collectives), but only ranks with write_outputs=True touch the
        # filesystem.  The CLI clears this on non-coordinators.
        self.write_outputs = True
        # When set, a resumable checkpoint is (re)written at every output
        # event (save_checkpoint is itself collective-symmetric and
        # rank-0-gated, so this is safe on every rank).
        self.checkpoint_path = None
        # Lazily-gathered host copy of the (immutable) static fields.
        self._static_full_cache = None
        self.scheme: Scheme = get_scheme(config.scheme)
        self.mesh = mesh
        if config.forecast_dt not in ("window", "step"):
            raise ValueError(f"forecast_dt must be 'window' or 'step', "
                             f"got {config.forecast_dt!r}")
        if config.forecast_dt_safety < 1.0:
            # A sub-1 margin makes every frozen-dt window violate its own
            # validation (dt > the CFL law it is checked against) and
            # churn the rollback retries forever.
            raise ValueError("forecast_dt_safety must be >= 1.0 "
                             f"(got {config.forecast_dt_safety})")

        if config.dtype == "float64" and not jax.config.jax_enable_x64:
            # The config asked for double precision; without this flag JAX
            # silently truncates every array to float32.
            jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64 if config.dtype == "float64" else jnp.float32
        self.dtype = dtype
        self.compensated = config.dtype == "float32c"

        self.backend = self._choose_backend(config.kernel_backend, dtype)
        self._mesh_window = (config.forecast_window
                             if (mesh is not None
                                 and config.sync_method == "forecast")
                             else 1)
        # Closed-edge walls span the scheme's full static ring so closed
        # domains conserve mass exactly (see Domain.apply_edge_treatment).
        # Single-precision modes shift the vertical datum out of the
        # arithmetic (Domain.build docstring); f64 stays absolute.
        self.state, self.static = domain.build(
            dtype=dtype, edge_wall_width=self.scheme.radius,
            datum_shift=(config.dtype != "float64"))
        self.carry = initial_carry(dtype, dt0=config.initial_timestep)
        self.comp = (jnp.zeros_like(self.state.z) if self.compensated
                     else None)
        if mesh is not None:
            # 2-D grid sharding; XLA inserts the halo collectives for the
            # stencil shifts and all-reduces the CFL max (the analogue of
            # the reference's link exchange + MPI_Allreduce(MIN)).
            from ..parallel.mesh import shard_simulation_arrays
            self.state, self.static = shard_simulation_arrays(
                mesh, self.state, self.static)
            if self.comp is not None:
                from ..parallel.mesh import grid_sharding
                self.comp = jax.device_put(self.comp, grid_sharding(mesh))

        self.params = SchemeParams(
            dx=domain.dx, dy=domain.dy,
            very_small=config.dry_threshold,
            quite_small=config.dry_threshold * 10.0,
            friction=config.friction,
            datum=domain.datum)
        self.ts_params = TimestepParams(
            courant=config.courant,
            dynamic=(config.timestep_mode == "cfl"),
            fixed_dt=config.fixed_timestep,
            simplified_speed=self.scheme.simplified_speed)

        if mesh is not None and config.sync_method == "forecast":
            from ..parallel.halo_deep import build_halo_deep_batch, halo_depth
            # The halo must fit inside each device's block; shrink the
            # exchange window until it does (the reference's rollback
            # limit = overlap-1 plays the same clamping role,
            # src/Domain/CDomainBase.cpp:163-174).
            py, px = mesh.devices.shape
            r_loc, c_loc = domain.rows // py, domain.cols // px
            block = min(r_loc, c_loc)
            while (self._mesh_window > 1
                   and halo_depth(self._mesh_window, self.scheme.radius)
                   > block):
                self._mesh_window -= 1
            if halo_depth(self._mesh_window, self.scheme.radius) > block:
                logging.getLogger(__name__).warning(
                    "mesh blocks %dx%d too small for any halo window; "
                    "falling back to per-step GSPMD halos", r_loc, c_loc)
                self._mesh_window = 1
                self._run_batch = self._build_run_batch()
            else:
                self._run_batch = build_halo_deep_batch(
                    mesh, self.scheme, self.params, self.ts_params,
                    self.boundaries, self.config.duration,
                    self._mesh_window,
                    domain.logical_rows, domain.logical_cols,
                    compensated=self.compensated,
                    dt_mode=config.forecast_dt,
                    dt_safety=config.forecast_dt_safety)
            self._steps_per_unit = self._mesh_window
        else:
            self._run_batch = self._build_run_batch()
            self._steps_per_unit = 1
        self._batch_size = max(1, int(config.batch_size))
        self.total_steps = 0
        self.total_skipped = 0
        self.wall_start = None

    # ------------------------------------------------------------------
    def _choose_backend(self, requested: str, dtype) -> str:
        """Resolve ``kernel_backend``: the GPU kernel (ops/triton_step.py)
        for first-order schemes in f32/f32c on a single GPU, XLA
        otherwise.  An explicit "triton" that cannot run raises."""
        from ..ops import triton_step
        if requested not in ("auto", "xla", "triton"):
            raise ValueError(f"kernel_backend must be 'auto', 'xla' or "
                             f"'triton', got {requested!r}")
        on_gpu = jax.devices()[0].platform == "gpu"
        fits = (self.mesh is None
                and triton_step.supports(self.scheme.name, dtype))
        if requested == "auto":
            return "triton" if (on_gpu and fits) else "xla"
        if requested == "triton" and not on_gpu:
            raise ValueError("kernel_backend='triton' needs a GPU; this "
                             f"process runs on "
                             f"{jax.devices()[0].platform!r}")
        if requested == "triton" and not fits:
            raise ValueError(
                "kernel_backend='triton' supports "
                f"{'/'.join(triton_step.SCHEMES)} in float32/float32c "
                "without a mesh")
        return requested

    # ------------------------------------------------------------------
    def _build_run_batch(self):
        scheme_step = self.scheme.step
        params = self.params
        ts_params = self.ts_params
        boundaries_static = self.boundaries
        end_time = self.config.duration
        use_kernel = self.backend == "triton"
        logical = (self.domain.logical_rows, self.domain.logical_cols)
        scheme_name = self.scheme.name
        if use_kernel:
            from ..ops.triton_step import triton_step

        ring = self.scheme.radius

        @partial(jax.jit, static_argnames=("n_steps",),
                 donate_argnames=("state", "carry", "comp"))
        def run_batch(state: FlowState, carry: StepCarry,
                      static: DomainStatic, sync_time, comp, n_steps: int):
            # Forcing allowed exactly on the logical grid minus the
            # scheme's static ghost ring — the same cell set the
            # halo-deep mesh path forces, so every execution path stays
            # bit-consistent (iota-built, fuses under jit).
            fmask = interior_force_mask(state.z.shape, logical[0],
                                        logical[1], ring)

            def body(sc, _):
                state, carry, comp = sc
                bout = apply_boundaries(boundaries_static, state, static,
                                        carry.t, carry.dt, carry.t_hydro,
                                        params, comp=comp, mask=fmask)
                state, comp = bout if comp is not None else (bout, None)
                if use_kernel:
                    out = triton_step(scheme_name, state, static, carry.dt,
                                      params, ts_params.simplified_speed,
                                      comp=comp)
                    if comp is None:
                        state, speed = out
                    else:
                        state, speed, comp = out
                else:
                    sout = scheme_step(state, static, carry.dt, params,
                                       comp=comp) if comp is not None \
                        else scheme_step(state, static, carry.dt, params)
                    state, comp = sout if comp is not None else (sout, None)
                    speed = max_wave_speed(state.z, state.zmax, state.qx,
                                           state.qy, static.zb,
                                           params.quite_small,
                                           ts_params.simplified_speed)
                carry = advance(carry, speed, sync_time, end_time,
                                params.dx, ts_params)
                return (state, carry, comp), None

            (state, carry, comp), _ = jax.lax.scan(
                body, (state, carry, comp), length=n_steps)
            # NaN/Inf probe: a diverged state never reaches the dt/t
            # scalars (non-finite cells mask as dry in the CFL), so fold
            # a zero-scaled state sum into the batch statistic the host
            # already reads — finite states add -0.0, divergence turns it
            # NaN (one reduction per batch, not per step).
            poison = 0.0 * jnp.sum(state.z)
            carry = carry._replace(
                batch_dt_total=carry.batch_dt_total + poison)
            return state, carry, comp

        return run_batch

    # ------------------------------------------------------------------
    def run_to(self, target_time: float, progress: Optional[Callable] = None):
        """Advance the simulation until the clock reaches target_time."""
        # The simulation clock carries the state dtype; a non-representable
        # target can only be matched to ~ulp(t), so the match tolerance
        # scales with the clock magnitude in f32 runs.
        eps = float(jnp.finfo(self.dtype).eps)
        tol = max(self.config.sync_tolerance, 8.0 * eps * abs(target_time))
        sync = jnp.asarray(target_time, dtype=self.dtype)
        while True:
            t_now = float(self.carry.t)
            if t_now >= target_time - tol:
                break
            t0 = time.perf_counter()
            self.state, self.carry, self.comp = self._run_batch(
                self.state, self.carry, self.static, sync, self.comp,
                n_steps=self._batch_size)
            # One host sync per batch (reference: readKeyStatistics).
            t_new = float(self.carry.t)
            elapsed = time.perf_counter() - t0
            dt_now = float(self.carry.dt)
            if (not np.isfinite(t_new) or np.isnan(dt_now)
                    or np.isnan(float(self.carry.batch_dt_total))):
                # Divergence check from the scalars already read back —
                # the reference's isSimulationFailure ladder
                # (src/Schemes/CSchemeGodunov.cpp:1523-1555).  dt = +/-inf
                # is NOT divergence: a fully dry domain has zero wave
                # speed and legitimately fast-forwards with an unbounded
                # (then clamped/suspended) timestep.
                raise RuntimeError(
                    f"Simulation diverged (t={t_new}, dt={dt_now}); "
                    "the CFL wave speed became non-finite")
            self.total_steps = int(self.carry.batch_successful)
            self.total_skipped = int(self.carry.batch_skipped)
            if progress is not None:
                progress(self, t_new, elapsed)
            if self.config.batch_auto:
                self._adapt_batch(elapsed)
            if t_new <= t_now and float(self.carry.dt) <= 0.0 \
                    and t_new < target_time - tol:
                raise RuntimeError(
                    f"Simulation stalled at t={t_new:.6f}s "
                    f"(dt={float(self.carry.dt):.3e})")

    def _adapt_batch(self, elapsed: float):
        """Size batches toward the wall-clock target, like the reference's
        adaptive queue (src/Schemes/CSchemeGodunov.cpp:1419-1448) but
        restricted to powers of two so jit caching stays bounded.

        The jump goes straight to the power of two nearest the target
        (each new size is a fresh jit compile, so halving/doubling
        repeatedly is expensive, not just slow to converge)."""
        target = self.config.batch_target_seconds
        if not (elapsed < target / 2 and self._batch_size < 4096) and \
                not (elapsed > target * 2 and self._batch_size > 8):
            return
        per_unit = max(elapsed / self._batch_size, 1e-9)
        ideal = max(1.0, target / per_unit)
        size = 8
        while size * 2 <= min(ideal, 4096):
            size *= 2
        self._batch_size = max(8, size)

    # ------------------------------------------------------------------
    def io_streaming(self) -> bool:
        """True when output/checkpoint events use the bounded-memory
        streamed path (runtime/sharded_io.py) instead of full-grid
        gathers."""
        mode = self.config.io_mode
        if mode in ("stream", "gather"):
            return mode == "stream"
        cells = self.domain.logical_rows * self.domain.logical_cols
        return cells >= self.config.io_stream_cells

    def emit_output(self, t: float):
        """Run one output event SPMD-symmetrically.

        Gathered mode: the global state is gathered ONCE on every process
        (collectives), then files are written only where write_outputs is
        set.  Streamed mode (large grids / io_mode='stream'): no full
        gather anywhere — every rank drives the writers' bounded chunk
        collectives, and the writers gate file writes on
        ``snap.write_files`` internally."""
        if self.output_writer is None and self.checkpoint_path is None:
            return
        if self.io_streaming():
            snap = _StreamingSnapshot(self)
            if self.checkpoint_path is not None:
                from .checkpoint import save_checkpoint
                save_checkpoint(self.checkpoint_path, self, snapshot=snap)
            if self.output_writer is not None:
                self.output_writer(snap, t)
            return
        snap = _OutputSnapshot(self)
        if self.checkpoint_path is not None:
            from .checkpoint import save_checkpoint
            save_checkpoint(self.checkpoint_path, self, snapshot=snap)
        if self.output_writer is not None and self.write_outputs:
            self.output_writer(snap, t)

    def run(self, progress: Optional[Callable] = None):
        """Full run with outputs at every output_frequency interval.
        On a resumed simulation, output events before the resume time are
        skipped (they belong to the original run)."""
        cfg = self.config
        self.wall_start = time.monotonic()
        t_start = float(self.carry.t)
        n_outputs = int(round(cfg.duration / cfg.output_frequency))
        for i in range(1, n_outputs + 1):
            target = min(i * cfg.output_frequency, cfg.duration)
            if target <= t_start + cfg.sync_tolerance:
                continue
            self.run_to(target, progress=progress)
            self.emit_output(target)
        if float(self.carry.t) < cfg.duration - cfg.sync_tolerance:
            self.run_to(cfg.duration, progress=progress)
            self.emit_output(cfg.duration)
        return self.state

    # ------------------------------------------------------------------
    @property
    def t(self) -> float:
        return float(self.carry.t)

    @property
    def state_logical(self) -> FlowState:
        lr, lc = self.domain.logical_rows, self.domain.logical_cols
        fetch = self._fetch_global
        return FlowState(*(fetch(a)[:lr, :lc] for a in self.state))

    @property
    def static_logical(self) -> DomainStatic:
        lr, lc = self.domain.logical_rows, self.domain.logical_cols
        fetch = self._fetch_global
        return DomainStatic(*(fetch(a)[:lr, :lc] for a in self.static))

    @staticmethod
    def _fetch_global(a) -> np.ndarray:
        """Host copy of a device array; under multi-host sharding the
        non-addressable shards are allgathered first (the reference's
        stream-to-rank-0, src/MPI/CMPIManager.cpp:468-550)."""
        if jax.process_count() > 1:
            from ..parallel.distributed import gather_to_host
            return gather_to_host(a)
        return np.asarray(a)

    def depth(self) -> np.ndarray:
        st = self.state_logical
        h = np.asarray(st.z) - np.asarray(self.static_logical.zb)
        h[np.asarray(st.zmax) <= C.NODATA] = 0.0
        return np.maximum(h, 0.0)

    def volume(self) -> float:
        if self.io_streaming():
            # Streamed-IO scale: an on-device reduction (replicated
            # scalar) instead of a full-grid gather — the gather would
            # defeat the bounded-memory mode (e.g. --mass-balance on a
            # 10^8-cell grid).
            v = _device_volume(self.state.z, self.state.zmax,
                               self.static.zb, self.domain.logical_rows,
                               self.domain.logical_cols)
            return float(v) * self.domain.dx * self.domain.dy
        from .output import domain_volume
        return domain_volume(self, self.domain)
