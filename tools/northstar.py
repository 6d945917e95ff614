"""North-star scale smoke: ~10^8 cells on ONE chip (SURVEY's hard-parts
target), measuring the steady scan rate AND a full streamed output +
checkpoint event at that scale.

Defaults: 10240 x 10240 = 104,857,600 cells, Godunov, compensated-f32,
automatic kernel choice.  Device memory: 7 f32 planes ~2.9 GB — well
inside one card's 80 GB.  The output event runs through the streamed I/O
path (io_mode auto engages far below this size), writing a deflate
GeoTIFF + a streamed checkpoint with bounded (io_chunk_mb) host chunks.

Writes results/northstar.json.  Env knobs: NORTHSTAR_ROWS/COLS,
NORTHSTAR_STEPS, NORTHSTAR_BACKEND, NORTHSTAR_SCHEME, NORTHSTAR_DTYPE.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from hipims_tpu.domain import Domain
    from hipims_tpu.runtime import Simulation, SimulationConfig
    from hipims_tpu.runtime.output import RasterOutputWriter
    from hipims_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    rows = int(os.environ.get("NORTHSTAR_ROWS", 10240))
    cols = int(os.environ.get("NORTHSTAR_COLS", 10240))
    steps = int(os.environ.get("NORTHSTAR_STEPS", 32))
    backend = os.environ.get("NORTHSTAR_BACKEND", "auto")
    scheme = os.environ.get("NORTHSTAR_SCHEME", "godunov")
    dtype = os.environ.get("NORTHSTAR_DTYPE", "float32c")

    t_start = time.time()
    # float32 host build keeps peak host memory ~1.7 GB at 10240^2.
    yy = np.arange(rows, dtype=np.float32)[:, None]
    xx = np.arange(cols, dtype=np.float32)[None, :]
    zb = 0.2 * np.sin(xx / 50.0) * np.cos(yy / 50.0)
    dom = Domain(zb=zb, manning=0.03, dx=10.0, dy=10.0)
    r2 = (yy - rows / 2.0) ** 2 + (xx - cols / 2.0) ** 2
    dom.set_initial_depth(np.where(r2 <= (rows / 6.0) ** 2, 8.0,
                                   2.0).astype(np.float32))
    del r2

    outdir = tempfile.mkdtemp(prefix="northstar_")
    writer = RasterOutputWriter(
        [dict(value="depth", format="tif", target="depth_%t.tif")],
        outdir, dom)
    cfg = SimulationConfig(scheme=scheme, duration=1e9,
                           output_frequency=1e9, dtype=dtype,
                           batch_size=steps, batch_auto=False,
                           kernel_backend=backend, io_mode="stream")
    sim = Simulation(dom, cfg, output_writer=writer)
    writer.domain = sim.domain
    assert sim.io_streaming()
    build_s = time.time() - t_start
    print(f"built: {rows}x{cols} backend={sim.backend} "
          f"({build_s:.0f}s)", flush=True)

    sync = jnp.asarray(1e9, dtype=sim.dtype)
    t0 = time.time()
    state, carry, comp = sim._run_batch(sim.state, sim.carry, sim.static,
                                        sync, sim.comp, n_steps=steps)
    jax.block_until_ready((state, carry, comp))
    compile_s = time.time() - t0
    print(f"warm batch (incl compile): {compile_s:.0f}s", flush=True)

    times = []
    for _i in range(2):
        t0 = time.time()
        state, carry, comp = sim._run_batch(state, carry, sim.static,
                                            sync, comp, n_steps=steps)
        jax.block_until_ready((state, carry, comp))
        times.append(time.time() - t0)
    rate = rows * cols * steps / min(times)
    print(f"rate: {rate / 1e9:.2f} G cells/s", flush=True)

    sim.state, sim.carry, sim.comp = state, carry, comp
    sim.checkpoint_path = os.path.join(outdir, "ck.npz")
    t0 = time.time()
    sim.emit_output(float(carry.t))
    event_s = time.time() - t0

    # Newest .tif = this event's raster (the dir may hold older runs').
    tif_files = [os.path.join(outdir, f) for f in os.listdir(outdir)
                 if f.endswith(".tif")]
    tif = max(tif_files, key=os.path.getmtime)
    art = dict(
        rows=rows, cols=cols, cells=rows * cols, scheme=scheme,
        dtype=dtype, backend=sim.backend,
        device=str(jax.devices()[0]),
        device_kind=jax.devices()[0].device_kind,
        steps_timed=steps,
        cells_per_s=round(rate, 1),
        warm_batch_incl_compile_s=round(compile_s, 1),
        output_event_s=round(event_s, 1),
        raster_bytes=os.path.getsize(tif),
        checkpoint_bytes=os.path.getsize(sim.checkpoint_path),
        io_chunk_mb=cfg.io_chunk_mb,
        final_dt_s=round(float(carry.dt), 4),
    )
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "northstar.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    merged = {}
    if os.path.exists(out):
        try:
            with open(out) as f:
                prev = json.load(f)
            # Legacy single-record layout folds into the keyed one.
            merged = prev if "runs" in prev else {
                "runs": {f"{prev.get('scheme', '?')}/"
                         f"{prev.get('dtype', '?')}": prev}}
        except Exception:  # noqa: BLE001
            merged = {}
    merged.setdefault("runs", {})[f"{scheme}/{dtype}"] = art
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    print(json.dumps(art), flush=True)
    print("->", out, flush=True)


if __name__ == "__main__":
    main()
