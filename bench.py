"""Headline benchmark: MUSCL-Hancock cell-update rate on one GPU.

Mirrors the reference's Malpasset configuration scale (~1.8-2M cells,
MUSCL-Hancock, dynamic CFL timestep, friction on) and reports cell-updates
per second beside the reference's best single-GPU 32-bit rate of
556 M cells/s (NVIDIA Tesla M2075, BASELINE.md).

Prints one JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, "extra": {...}}

With --full (or BENCH_FULL=1) it also sweeps all three schemes and all
precisions, one JSON line each on stderr.

A rate is a device number, so anything but a GPU is refused unless
JAX_PLATFORMS=cpu is set explicitly (a CPU rate is then labelled cpu).

Environment knobs (defaults in parentheses):
  BENCH_ROWS/BENCH_COLS (1408)  grid
  BENCH_STEPS (200), BENCH_REPS (3), BENCH_STEPS_F64 (20)
  BENCH_SCHEME (muscl-hancock), BENCH_DTYPE (float32),
  BENCH_BACKEND (auto)
  BENCH_MESH (unset)            run on an N-device mesh
  BENCH_SYNC (timestep)         mesh sync discipline; "forecast" enables
                                halo-deep windows with the amortised
                                (one-collective-per-window) dt
  BENCH_WINDOW (8)              steps per forecast exchange window
  BENCH_SKIP_EXTRA=1            headline only (no f32c/f64/mesh extras)
"""

import json
import os
import sys
import time

# Reference rates from BASELINE.md (Malpasset, config A — the fastest —
# on the best GPU, NVIDIA Tesla M2075).
BASELINE_F32 = 556e6   # 32-bit MUSCL-Hancock
BASELINE_F64 = 159e6   # 64-bit MUSCL-Hancock


def build_domain(rows, cols):
    """Fully wet radial dam break over a gently undulating bed: no
    dry-cell shortcuts, friction active everywhere — worst-case honest
    rate."""
    import numpy as np

    from hipims_tpu.domain import Domain

    yy, xx = np.mgrid[0:rows, 0:cols]
    zb = 0.2 * np.sin(xx / 50.0) * np.cos(yy / 50.0)
    dom = Domain(zb=zb, manning=0.03, dx=10.0, dy=10.0)
    r = np.hypot((yy - rows / 2) * 10.0, (xx - cols / 2) * 10.0)
    dom.set_initial_depth(np.where(r <= rows * 10.0 / 6.0, 8.0, 2.0))
    return dom


def run_case(scheme, dtype, backend, rows, cols, steps, reps,
             mesh_n=None, sync=None, window=None):
    """Return (rate_cells_per_s, elapsed, sim, carry) for one config."""
    import jax
    import jax.numpy as jnp

    from hipims_tpu.runtime import Simulation, SimulationConfig

    mesh = None
    if mesh_n is None and os.environ.get("BENCH_MESH"):
        mesh_n = int(os.environ["BENCH_MESH"])
    if mesh_n:
        from hipims_tpu.parallel import make_mesh
        mesh = make_mesh(mesh_n)

    # Forecast-window knobs (BENCH_SYNC=forecast BENCH_WINDOW=K): under a
    # mesh, K steps share one halo exchange AND one CFL collective
    # (parallel/halo_deep.py dt_mode="window").
    sync = sync or os.environ.get("BENCH_SYNC", "timestep")
    window = window if window is not None else int(
        os.environ.get("BENCH_WINDOW", 8))
    cfg = SimulationConfig(scheme=scheme, duration=1e9,
                           output_frequency=1e9, dtype=dtype,
                           batch_size=steps, batch_auto=False,
                           kernel_backend=backend,
                           sync_method=sync, forecast_window=window)
    sim = Simulation(build_domain(rows, cols), cfg, mesh=mesh)
    sync_t = jnp.asarray(1e9, dtype=sim.dtype)
    # ``steps`` counts PHYSICAL steps; the halo-deep forecast path scans
    # windows, so convert (and report the true cell-update rate).
    units = max(1, steps // sim._steps_per_unit)
    physical = units * sim._steps_per_unit

    state, carry, comp = sim._run_batch(sim.state, sim.carry, sim.static,
                                        sync_t, sim.comp, n_steps=units)
    jax.block_until_ready((state, carry, comp))

    times = []
    for _i in range(reps):
        t0 = time.perf_counter()
        state, carry, comp = sim._run_batch(state, carry, sim.static,
                                            sync_t, comp, n_steps=units)
        jax.block_until_ready((state, carry, comp))
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    return rows * cols * physical / elapsed, elapsed, sim, carry


def device_info():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    from hipims_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    if device["platform"] != "gpu" and \
            os.environ.get("JAX_PLATFORMS", "").lower() != "cpu":
        print(f"bench.py measures a GPU; found {device['platform']!r} "
              "(set JAX_PLATFORMS=cpu to time the CPU on purpose)",
              file=sys.stderr)
        return 1

    rows = int(os.environ.get("BENCH_ROWS", 1408))
    cols = int(os.environ.get("BENCH_COLS", 1408))
    steps = int(os.environ.get("BENCH_STEPS", 200))
    scheme = os.environ.get("BENCH_SCHEME", "muscl-hancock")
    backend = os.environ.get("BENCH_BACKEND", "auto")
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    reps = int(os.environ.get("BENCH_REPS", 3))
    f64_steps = int(os.environ.get("BENCH_STEPS_F64", 20))
    full = "--full" in sys.argv or os.environ.get("BENCH_FULL") == "1"

    suffixes = {"float64": "f64", "float32": "f32", "float32c": "f32c"}
    baselines = {"float64": BASELINE_F64, "float32": BASELINE_F32,
                 "float32c": BASELINE_F64}   # f32c is the f64-accuracy mode

    rate, elapsed, sim, carry = run_case(scheme, dtype, backend, rows,
                                         cols, steps, reps)
    out = {
        "metric": f"{scheme.replace('-', '_')}_cell_updates_per_s_"
                  f"{suffixes[dtype]}",
        "value": round(rate, 1),
        "unit": "cells/s",
        "vs_baseline": round(rate / baselines[dtype], 4),
        "device": device,
        "backend": sim.backend,
    }

    # The precision story in the same line: the compensated-f32 mode and
    # f64, both beside the reference's 159 M cells/s f64 GPU rate, and
    # the 1-device-mesh rate (the halo-deep shard_map machinery).
    extra = {}
    if os.environ.get("BENCH_SKIP_EXTRA") != "1":
        for dt_, st in (("float32c", steps), ("float64", f64_steps)):
            if dt_ == dtype:
                continue
            r, _, _, _ = run_case(scheme, dt_, backend if dt_ != "float64"
                                  else "xla", rows, cols, st,
                                  max(1, reps - 1))
            extra[f"{suffixes[dt_]}_cells_per_s"] = round(r, 1)
            extra[f"{suffixes[dt_]}_vs_f64_baseline"] = round(
                r / BASELINE_F64, 4)
        r, _, sm, _ = run_case(scheme, dtype, "xla", rows, cols, steps,
                               max(2, reps - 1), mesh_n=1)
        extra["mesh1_cells_per_s"] = round(r, 1)
        extra["mesh1_frac_of_single"] = round(r / rate, 4)
    if extra:
        out["extra"] = extra
    print(json.dumps(out), flush=True)
    print(f"# grid={rows}x{cols} steps={steps} elapsed={elapsed:.3f}s "
          f"t_sim={float(carry.t):.3f}s dt={float(carry.dt):.4f}s "
          f"device={device} backend={sim.backend}", file=sys.stderr)

    if not full:
        return 0
    cases = [
        # (scheme, dtype, backend, steps, baseline)
        ("muscl-hancock", "float32", "auto", steps, BASELINE_F32),
        ("muscl-hancock", "float32c", "auto", steps, BASELINE_F64),
        ("godunov", "float32", "auto", steps, None),
        ("godunov", "float32c", "auto", steps, BASELINE_F64),
        ("inertial", "float32", "auto", steps, None),
        ("muscl-hancock", "float64", "xla", f64_steps, BASELINE_F64),
        ("godunov", "float64", "xla", f64_steps, None),
    ]
    for sch, dt_, bk, st, base in cases:
        r, el, sm, _ = run_case(sch, dt_, bk, rows, cols, st,
                                max(1, reps - 1))
        entry = {
            "metric": f"{sch.replace('-', '_')}_cell_updates_per_s_"
                      f"{suffixes[dt_]}",
            "value": round(r, 1), "unit": "cells/s",
            "scheme": sch, "dtype": dt_, "backend": sm.backend,
            "steps": st, "grid": [rows, cols], "device": device,
        }
        if base:
            entry["vs_baseline"] = round(r / base, 4)
        print(json.dumps(entry), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
