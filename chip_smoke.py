"""On-card proof that the system runs its main path on an NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the mesh phase only

One process drives the card(s); the only child is ``nvidia-smi``.  Each
check prints one line.  A failed check exits non-zero and prints no
``ok`` line; the last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Phases (one card):

* device — platform, device_kind, count, JAX version, XLA_FLAGS, and the
  card's name and power limit from nvidia-smi.  Anything but a GPU fails.
* timing — the Triton first-order step (ops/triton_step.py) against the
  XLA step, in turns XLA, Triton, Triton, XLA, median of 5 batches each,
  for Godunov and inertial in f32 and f32c at 2816^2 and 320^2.
* end-to-end — two reference-class deployments (tools/bench_e2e.py
  builders) at full grid size through the CLI with --mass-balance, for a
  shortened simulated time: the rasters are read back and the logged
  volume is checked.
* correctness — each scheme x {f32, f32c, f64} on the card against XLA on
  the CPU in f64, after a few steps of a fully wet 2816^2 dam break, and
  the Triton kernel against the XLA step on the card.  It runs last
  because it turns on ``jax_enable_x64`` for the whole process, which
  must not reach the f32 timings and CLI runs.

``--four-cards`` runs a Godunov f32c grid of 8192^2 with gridded rain
and a cell inflow on a 2x2 mesh, under per-step (timestep) and
windowed (forecast, K=8) sync, against the single-card run of the same
grid.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# f32/f32c bounds are this factor times the CPU f32(c)-vs-CPU-f64
# difference on the same case: the card's f32 arithmetic rounds in a
# different order than the CPU's (FMA contraction, fusion), so its error
# against f64 is of the same size but not the same bits.
F32_FACTOR = 4.0
# f64 on the card against f64 on the CPU: FMA contraction is the only
# expected difference, a few ulps per step.
F64_BOUND = 1e-9


class SmokeFailure(Exception):
    """A check that did not hold."""


def check(cond: bool, line: str):
    print(("PASS " if cond else "FAIL ") + line, flush=True)
    if not cond:
        raise SmokeFailure(line)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def phase_device(need: int = 1) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)} jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    check(d.platform == "gpu",
          f"device: platform is gpu (found {d.platform!r})")
    check(len(devs) >= need, f"device: {len(devs)} >= {need} cards")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = smi.stdout.strip().splitlines() if smi.returncode == 0 \
            else []
    except (OSError, subprocess.SubprocessError):
        lines = []
    for ln in lines:
        print(f"nvidia-smi: {ln.strip()}", flush=True)
    check(bool(lines), "device: nvidia-smi reports the card")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def step_seconds(sim, n_steps: int, batches: int = 5, warm: bool = True):
    """Median seconds per step over ``batches`` batches of ``n_steps``
    (each ended by block_until_ready), after one warm-up batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sync = jnp.asarray(1e9, sim.dtype)

    def batch():
        sim.state, sim.carry, sim.comp = sim._run_batch(
            sim.state, sim.carry, sim.static, sync, sim.comp,
            n_steps=n_steps)
        jax.block_until_ready((sim.state, sim.carry, sim.comp))

    if warm:
        batch()
    times = []
    for _ in range(batches):
        t0 = time.perf_counter()
        batch()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / n_steps, times


def xla_bytes_per_cell(scheme: str, dtype: str, n: int) -> float:
    """XLA's cost-model estimate of device-memory bytes per cell for one
    step + CFL reduce (the sum of its fusions' operands and results)."""
    import jax.numpy as jnp

    from bench import build_domain
    from hipims_tpu.runtime import Simulation, SimulationConfig

    sim = Simulation(build_domain(n, n), SimulationConfig(
        scheme=scheme, dtype=dtype, kernel_backend="xla"))
    compiled = sim._run_batch.lower(
        sim.state, sim.carry, sim.static, jnp.asarray(1e9, sim.dtype),
        sim.comp, n_steps=1).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost.get("bytes accessed", float("nan"))) / (n * n)


def phase_timing(sizes=((2816, 50), (320, 200)),
                 schemes=("godunov", "inertial"),
                 dtypes=("float32", "float32c")) -> dict:
    """Triton against XLA per (scheme, dtype, n).  Returns the verdicts."""
    from bench import build_domain
    from hipims_tpu.runtime import Simulation, SimulationConfig

    verdict = {}
    for scheme in schemes:
        for dtype in dtypes:
            # Planes read + planes written by one fused step, 4 B each.
            min_bytes = (7 + 5) * 4 if dtype == "float32c" else (6 + 4) * 4
            for n, k in sizes:
                sims = {b: Simulation(build_domain(n, n), SimulationConfig(
                    scheme=scheme, dtype=dtype, duration=1e9,
                    output_frequency=1e9, batch_size=k, batch_auto=False,
                    kernel_backend=b)) for b in ("xla", "triton")}
                turns = {"xla": [], "triton": []}
                samples = {"xla": [], "triton": []}
                for b in ("xla", "triton", "triton", "xla"):
                    s, raw = step_seconds(sims[b], k,
                                          warm=not turns[b])
                    turns[b].append(s)
                    samples[b] += [t / k for t in raw]
                med = {b: sorted(v)[len(v) // 2] for b, v in
                       samples.items()}
                spread = {b: max(v) - min(v) for b, v in turns.items()}
                cells = n * n
                print(f"timing {scheme} {dtype} {n}^2: "
                      f"xla {med['xla'] * 1e6:.1f} us/step "
                      f"(turns {[round(t * 1e6, 1) for t in turns['xla']]}"
                      f") triton {med['triton'] * 1e6:.1f} us/step "
                      f"(turns "
                      f"{[round(t * 1e6, 1) for t in turns['triton']]}) "
                      f"speedup {med['xla'] / med['triton']:.3f} "
                      f"triton {min_bytes * cells / med['triton'] / 1e9:.0f}"
                      f" GB/s at the fused minimum {min_bytes} B/cell",
                      flush=True)
                verdict[(scheme, dtype, n)] = (med, max(spread.values()))
                del sims
    big, small = sizes[0][0], sizes[1][0]
    for scheme in schemes:
        faster = all(m["triton"] + sp < m["xla"] for m, sp in
                     (verdict[(scheme, d, big)] for d in dtypes))
        not_slower = all(m["triton"] <= m["xla"] + sp for m, sp in
                         (verdict[(scheme, d, small)] for d in dtypes))
        print(f"timing verdict {scheme}: triton faster at {big}^2 beyond "
              f"the turn spread: {faster}; not slower at {small}^2 beyond "
              f"the turn spread: {not_slower}", flush=True)
    for scheme in schemes:
        for dtype in dtypes:
            n = sizes[0][0]
            print(f"timing xla-bytes {scheme} {dtype} {n}^2: "
                  f"{xla_bytes_per_cell(scheme, dtype, n):.1f} B/cell "
                  "(XLA cost model)", flush=True)
    return verdict


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def run_deployment(name: str, precision: str, workdir: str,
                   duration: float, outfreq: float, **size) -> dict:
    """Build a tools/bench_e2e.py deployment, run it through the CLI with
    --mass-balance, read the rasters back and check the logged volume
    against them (and, for the closed dam break, against the start)."""
    import numpy as np

    from hipims_tpu.cli import main as cli_main
    from hipims_tpu.io.raster import read_raster
    from tools import bench_e2e

    build = {"malpasset": bench_e2e.build_malpasset_class,
             "thamesmead": bench_e2e.build_thamesmead_class}[name]
    root = os.path.join(workdir, name)
    spec = build(root, duration=duration, outfreq=outfreq, **size)
    xml_path = os.path.join(root, "model.xml")
    with open(xml_path, "w") as f:
        f.write(bench_e2e.XML.format(precision=precision, **spec))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-c", xml_path, "-n", "--mass-balance"])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    check(rc == 0, f"e2e {name}: CLI exit code {rc}")
    dev = re.search(r"Device:\s+(.*)", out)
    steps = re.search(r"Iterations:\s+(\d+)", out)
    vols = [float(v) for v in
            re.findall(r"Mass balance: t=\S+s volume=(\S+) m3", out)]
    prec = re.search(r"Precision:\s+(\S+)", out)
    outdir = os.path.join(root, "output")
    rasters = sorted(os.listdir(outdir)) if os.path.isdir(outdir) else []
    depth_files = sorted((f for f in rasters if f.startswith("depth_")),
                         key=lambda f: float(f[6:].rsplit(".", 1)[0]))
    rows, cols, dx = spec["rows"], spec["cols"], spec["dx"]
    check(len(depth_files) >= 2 and len(vols) == len(depth_files),
          f"e2e {name}: {len(depth_files)} depth outputs, "
          f"{len(vols)} volume lines")
    last = read_raster(os.path.join(outdir, depth_files[-1]))
    depth = np.asarray(last.to_domain_array(), np.float64)
    good = depth != last.nodata
    raster_vol = float(depth[good].sum()) * dx * dx
    check(depth.shape == (rows, cols) and np.isfinite(depth).all()
          and float(depth[good].min()) >= 0.0,
          f"e2e {name}: depth raster {depth.shape} finite, >= 0")
    rel = abs(raster_vol - vols[-1]) / max(vols[-1], 1e-30)
    check(rel < 1e-4, f"e2e {name}: logged volume {vols[-1]:.6g} m3 vs "
          f"read-back raster {raster_vol:.6g} m3 (rel {rel:.2e} < 1e-4)")
    info = dict(wall=wall, steps=int(steps.group(1)) if steps else None,
                outputs=len(rasters), volumes=vols,
                device=dev.group(1).strip() if dev else None,
                precision=prec.group(1) if prec else None)
    print(f"e2e {name}: {rows}x{cols} {spec['scheme']} "
          f"{info['precision']} on [{info['device']}] simulated "
          f"{duration:g} s in {wall:.1f} s wall (compile included), "
          f"{info['steps']} steps, {len(rasters)} rasters, volumes "
          f"{[f'{v:.6g}' for v in vols]}", flush=True)
    return info


def phase_end_to_end(workdir: str, duration: float = 60.0,
                     outfreq: float = 30.0, small: bool = False):
    size_m = dict(rows=32, cols=48) if small else {}
    size_t = dict(rows=40, cols=36) if small else {}
    # Malpasset-class: a closed valley, so the volume is conserved.
    m = run_deployment("malpasset", "float", workdir, duration, outfreq,
                       **size_m)
    v0 = m["volumes"][0]
    drift = max(abs(v - v0) for v in m["volumes"]) / v0
    check(drift < 1e-5, f"e2e malpasset: closed-domain volume drift "
          f"{drift:.2e} < 1e-5 of {v0:.6g} m3")
    # Thamesmead-class: XML 'double' (f32c); the breach only adds water.
    t = run_deployment("thamesmead", "double", workdir, duration, outfreq,
                       **size_t)
    vols = t["volumes"]
    check(t["precision"] == "float32c",
          f"e2e thamesmead: XML double ran as {t['precision']}")
    # The breach cells take the hydrograph's 400 m3/s as unit-width
    # discharge and add |q| dt / dy of depth per step (CellBoundary,
    # ops/boundaries.py), i.e. 400 * dx m3 per second over the breach;
    # the critical-depth floor of the first step adds a little more.
    for i, v in enumerate(vols):
        want = 400.0 * 2.0 * outfreq * (i + 1)
        check(want * (1 - 1e-3) <= v <= want * 1.1,
              f"e2e thamesmead: volume {v:.6g} m3 at t={outfreq * (i + 1):g}"
              f" s within [1, 1.1] x the injected {want:.6g} m3")


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------

def _after_steps(scheme, dtype, device, backend, n, steps):
    """(h, qx, qy) as f64 host arrays after ``steps`` steps of the fully
    wet dam break on ``device``.  f32c adds its residue to the surface."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build_domain
    from hipims_tpu.runtime import Simulation, SimulationConfig

    with jax.default_device(device):
        sim = Simulation(build_domain(n, n), SimulationConfig(
            scheme=scheme, dtype=dtype, duration=1e9, output_frequency=1e9,
            batch_size=steps, batch_auto=False, kernel_backend=backend))
        st, carry, comp = sim._run_batch(
            sim.state, sim.carry, sim.static, jnp.asarray(1e9, sim.dtype),
            sim.comp, n_steps=steps)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    z = f64(st.z) + (f64(comp) if comp is not None else 0.0)
    # Depth is datum-free (single precision stores elevations relative
    # to a shifted datum, f64 does not); wall and disabled cells are 0.
    h = np.where(f64(st.zmax) > -9999.0,
                 np.maximum(z - f64(sim.static.zb), 0.0), 0.0)
    return h, f64(st.qx), f64(st.qy), float(carry.t), sim.backend


def _diff(a, b):
    return max(float(abs(x - y).max()) for x, y in zip(a[:3], b[:3]))


def phase_correctness(n: int = 2816, steps: int = 8, card=None,
                      kernel: bool = True):
    """Each scheme x precision on ``card`` against XLA f64 on the CPU."""
    import jax

    jax.config.update("jax_enable_x64", True)
    cpu = jax.devices("cpu")[0]
    card = card if card is not None else jax.devices()[0]
    print(f"correctness: {n}^2 fully wet dam break, {steps} steps; the "
          "step has no matrix product, so TF32 does not apply", flush=True)
    kernel_schemes = ("godunov", "inertial") if kernel else ()
    for scheme in ("godunov", "muscl-hancock", "inertial"):
        ref = _after_steps(scheme, "float64", cpu, "xla", n, steps)
        got = _after_steps(scheme, "float64", card, "xla", n, steps)
        d = _diff(got, ref)
        check(d <= F64_BOUND and abs(got[3] - ref[3]) < 1e-9,
              f"correctness {scheme} f64 card-xla vs cpu-f64: "
              f"max|dh|,|dq| {d:.3e} <= {F64_BOUND:.0e}, t {got[3]}")
        for dtype in ("float32", "float32c"):
            cpu32 = _after_steps(scheme, dtype, cpu, "xla", n, steps)
            bound = F32_FACTOR * _diff(cpu32, ref)
            runs = [("xla", _after_steps(scheme, dtype, card, "xla", n,
                                         steps))]
            if scheme in kernel_schemes:
                runs.append(("triton", _after_steps(
                    scheme, dtype, card, "triton", n, steps)))
            for backend, run in runs:
                d = _diff(run, ref)
                check(d <= bound and abs(run[3] - ref[3]) < 1e-4,
                      f"correctness {scheme} {dtype} card-{backend} vs "
                      f"cpu-f64: max|dh|,|dq| {d:.3e} <= {bound:.3e} "
                      f"({F32_FACTOR:g} x cpu-{dtype} error)")
            if len(runs) == 2:
                d = _diff(runs[1][1], runs[0][1])
                check(d <= bound, f"correctness {scheme} {dtype} "
                      f"card-triton vs card-xla: {d:.3e} <= {bound:.3e}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _mesh_sim(n, mesh, sync, duration, device=None):
    import jax

    from __graft_entry__ import _cell_inflow, _quadrant_rain
    from hipims_tpu.domain import Domain
    from hipims_tpu.runtime import Simulation, SimulationConfig
    import numpy as np

    yy, xx = np.mgrid[0:n, 0:n]
    dom = Domain(zb=np.zeros((n, n)), manning=0.03, dx=2.0, dy=2.0)
    r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
    dom.set_initial_depth(np.where(r <= n / 4.0, 2.5, 0.5))
    cfg = SimulationConfig(scheme="godunov", dtype="float32c",
                           duration=duration, output_frequency=duration,
                           batch_size=8, batch_auto=False,
                           kernel_backend="xla", sync_method=sync,
                           forecast_window=8)
    with jax.default_device(device) if device is not None \
            else contextlib.nullcontext():
        return Simulation(dom, cfg, mesh=mesh, boundaries=(
            _quadrant_rain(n, 2.0), _cell_inflow(n)))


def phase_four_cards(n: int = 8192, duration: float = 20.0, devices=None,
                     z_bound: float = 1e-4):
    import gc

    import jax
    import numpy as np

    from hipims_tpu.parallel import make_mesh

    devices = devices if devices is not None else jax.devices()
    check(len(devices) >= 4, f"four-cards: {len(devices)} >= 4 devices")
    t0 = time.perf_counter()
    ref = _mesh_sim(n, None, "timestep", duration, device=devices[0])
    ref.run()
    ref_t, ref_vol = ref.t, ref.volume()
    ref_z = np.asarray(ref.state.z, np.float64) \
        + np.asarray(ref.comp, np.float64)
    print(f"four-cards: single card {n}^2 godunov f32c t={ref_t} "
          f"steps={ref.total_steps} volume={ref_vol:.9g} m3 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del ref
    gc.collect()
    mesh = make_mesh(4, devices=devices[:4])
    for sync in ("timestep", "forecast"):
        t0 = time.perf_counter()
        sim = _mesh_sim(n, mesh, sync, duration)
        sim.run()
        wall = time.perf_counter() - t0
        for d in devices[:4]:
            stats = d.memory_stats() or {}
            print(f"four-cards {sync}: {d} bytes_in_use="
                  f"{stats.get('bytes_in_use')} peak="
                  f"{stats.get('peak_bytes_in_use')}", flush=True)
        z = np.asarray(sim.state.z, np.float64) \
            + np.asarray(sim.comp, np.float64)
        dz = float(np.abs(z - ref_z).max())
        vol = sim.volume()
        rel = abs(vol - ref_vol) / ref_vol
        print(f"four-cards {sync}: mesh {mesh.devices.shape} window "
              f"{sim._mesh_window} t={sim.t} steps={sim.total_steps} "
              f"volume={vol:.9g} m3 ({wall:.1f} s incl. compile)",
              flush=True)
        check(sim.t == ref_t, f"four-cards {sync}: t {sim.t} == {ref_t}")
        check(rel < 1e-6, f"four-cards {sync}: volume rel diff "
              f"{rel:.2e} < 1e-6")
        check(dz <= z_bound, f"four-cards {sync}: max|dz| {dz:.3e} <= "
              f"{z_bound:.0e} m")
        del sim
        gc.collect()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 2x2 mesh phase on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        from hipims_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"FAIL setup: the hipims_tpu package is not next to "
              f"{os.path.basename(__file__)} ({e})", file=sys.stderr)
        return 2
    enable_compile_cache()
    try:
        device = phase_device(need=4 if args.four_cards else 1)
        if args.four_cards:
            phase_four_cards()
        else:
            phase_timing()
            workdir = tempfile.mkdtemp(prefix="chip_smoke_")
            try:
                phase_end_to_end(workdir)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            phase_correctness()
    except SmokeFailure as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
