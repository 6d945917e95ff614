"""Actual multi-process jax.distributed run.

Two CPU processes (4 virtual devices each) form one 8-device cluster via a
localhost coordinator, run the same sharded simulation SPMD, gather the
global state, and must reproduce the single-process 8-device result.  The
reference's equivalent machinery is CMPIManager's config broadcast, device
census and halo Isend/Recv (src/MPI/CMPIManager.cpp:185-360, 555-714);
under JAX the same-file SPMD contract plus GSPMD collectives replace all
of it, which is exactly what this test demonstrates end to end.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]

from hipims_tpu.parallel.distributed import (gather_to_host,
                                             host_summary,
                                             initialize_cluster,
                                             is_coordinator)
assert initialize_cluster(coord, 2, pid)
assert jax.process_count() == 2
assert len(jax.devices()) == 8
assert len(jax.local_devices()) == 4
summary = host_summary()
assert summary["process_index"] == pid

import numpy as np
from hipims_tpu.domain import Domain
from hipims_tpu.parallel import make_mesh
from hipims_tpu.runtime import Simulation, SimulationConfig

n = 64
zb = np.zeros((n, n))
dom = Domain(zb=zb, manning=0.0, dx=2.0, dy=2.0)
yy, xx = np.mgrid[0:n, 0:n]
r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
dom.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
cfg = SimulationConfig(scheme="godunov", duration=2.0, output_frequency=1.0,
                       batch_size=4, batch_auto=False)

# Raster outputs through the SPMD-symmetric path: every rank runs the
# gathers (collectives), only the coordinator touches the filesystem —
# asymmetric writers used to deadlock here (ADVICE r3).
from hipims_tpu.runtime.output import RasterOutputWriter
raster_dir = os.path.join(outdir, "rasters")
writer = RasterOutputWriter(
    [dict(value="depth", format="tif", target="depth_%t.tif")],
    raster_dir, dom)
sim = Simulation(dom, cfg, mesh=make_mesh(8), output_writer=writer)
sim.write_outputs = is_coordinator()
sim.run()

z = gather_to_host(sim.state.z)          # full global array on every host
vol = sim.volume()                        # exercises the gathering getters

# Checkpoint/resume across the cluster: the save gathers on every rank
# (collective) and writes on rank 0 only; the resumed run's continuation
# is compared against a single-process resume by the pytest driver.
from hipims_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint
ck = os.path.join(outdir, "cluster_ck.npz")
save_checkpoint(ck, sim)
cfg2 = SimulationConfig(scheme="godunov", duration=3.0,
                        output_frequency=3.0, batch_size=4,
                        batch_auto=False)
dom2 = Domain(zb=np.zeros((n, n)), manning=0.0, dx=2.0, dy=2.0)
dom2.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
sim2 = Simulation(dom2, cfg2, mesh=make_mesh(8))
load_checkpoint(ck, sim2)
assert abs(sim2.t - sim.t) < 1e-12
sim2.run_to(3.0)
z3 = gather_to_host(sim2.state.z)
t3 = sim2.t

# ---- Phase B: MUSCL-Hancock + forecast halo-deep
# windows + a position-dependent gridded (radar) boundary + STREAMED
# output I/O, all under the real 2-process cluster.  The streamed writer
# must produce byte-identical rasters to the gathered writer.
from hipims_tpu.ops.boundaries import GriddedBoundary
from hipims_tpu.runtime.output import RasterOutputWriter

series = np.zeros((4, 2, 2))
series[:, 1, 1] = 3600.0                  # mm/hr, NE quadrant only
rain = GriddedBoundary(series=series, interval=600.0,
                       resolution=n * 2.0 / 2.0, offset_x=0.0,
                       offset_y=0.0, mass_flux=False, length=2400.0)

def build_b(io_mode, outsub):
    domB = Domain(zb=np.zeros((n, n)), manning=0.02, dx=2.0, dy=2.0)
    domB.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
    cfgB = SimulationConfig(scheme="muscl-hancock", duration=3.0,
                            output_frequency=1.5, batch_size=2,
                            batch_auto=False, sync_method="forecast",
                            forecast_window=2, io_mode=io_mode)
    wB = RasterOutputWriter(
        [dict(value="depth", format="tif", target="d_%t.tif")],
        os.path.join(outdir, outsub), domB)
    simB = Simulation(domB, cfgB, boundaries=(rain,), mesh=make_mesh(8),
                      output_writer=wB)
    simB.write_outputs = is_coordinator()
    return simB

simB = build_b("stream", "rastersB_stream")
simB.run()
zB = gather_to_host(simB.state.z)
volB = simB.volume()
simBg = build_b("gather", "rastersB_gather")
simBg.run()
assert abs(simBg.t - simB.t) < 1e-9
np.testing.assert_array_equal(gather_to_host(simBg.state.z), zB)

if is_coordinator():
    import glob
    sfiles = sorted(glob.glob(os.path.join(outdir, "rastersB_stream/*")))
    gfiles = sorted(glob.glob(os.path.join(outdir, "rastersB_gather/*")))
    assert len(sfiles) == 2 and len(gfiles) == 2, (sfiles, gfiles)
    for sf, gf in zip(sfiles, gfiles):
        assert open(sf, "rb").read() == open(gf, "rb").read(), (sf, gf)
    np.savez(os.path.join(outdir, "result.npz"), z=z, t=sim.t, vol=vol,
             z3=z3, t3=t3, zB=zB, tB=simB.t, volB=volB)
else:
    # The coordinator gate: rank 1 must NOT write outputs.
    assert not is_coordinator()
    np.savez(os.path.join(outdir, "rank1.npz"), ok=True, vol=vol,
             volB=volB)
print("WORKER_DONE", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_cluster_matches_single(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid), str(tmp_path)],
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_DONE {pid}" in out

    res = np.load(tmp_path / "result.npz")
    rank1 = np.load(tmp_path / "rank1.npz")

    # Single-process 8-device reference (this pytest process).
    from hipims_tpu.domain import Domain
    from hipims_tpu.parallel import make_mesh
    from hipims_tpu.runtime import Simulation, SimulationConfig

    n = 64
    dom = Domain(zb=np.zeros((n, n)), manning=0.0, dx=2.0, dy=2.0)
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
    dom.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
    cfg = SimulationConfig(scheme="godunov", duration=2.0,
                           output_frequency=1.0, batch_size=4,
                           batch_auto=False)
    ref = Simulation(dom, cfg, mesh=make_mesh(8))
    ref.run()

    assert float(res["t"]) == pytest.approx(ref.t, abs=1e-9)
    np.testing.assert_allclose(res["z"], np.asarray(ref.state.z),
                               rtol=1e-7, atol=5e-9)
    # Both ranks see the same gathered volume.
    assert float(rank1["vol"]) == pytest.approx(float(res["vol"]),
                                                rel=1e-12)
    assert float(res["vol"]) == pytest.approx(ref.volume(), rel=1e-9)

    # Rank-0-only raster outputs were written through the symmetric path.
    rasters = sorted(os.listdir(tmp_path / "rasters"))
    assert len(rasters) == 2 and all(r.startswith("depth_")
                                     for r in rasters)

    # Cluster checkpoint -> resume matches the single-process resume.
    from hipims_tpu.runtime.checkpoint import load_checkpoint
    cfg3 = SimulationConfig(scheme="godunov", duration=3.0,
                            output_frequency=3.0, batch_size=4,
                            batch_auto=False)
    dom3 = Domain(zb=np.zeros((n, n)), manning=0.0, dx=2.0, dy=2.0)
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
    dom3.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
    ref3 = Simulation(dom3, cfg3, mesh=make_mesh(8))
    load_checkpoint(tmp_path / "cluster_ck.npz", ref3)
    assert ref3.t == pytest.approx(float(res["t"]), abs=1e-12)
    ref3.run_to(3.0)
    assert float(res["t3"]) == pytest.approx(ref3.t, abs=1e-9)
    np.testing.assert_allclose(res["z3"], np.asarray(ref3.state.z),
                               rtol=1e-7, atol=5e-9)

    # Phase B: the cluster's MUSCL + forecast + gridded-rain + streamed-IO
    # run must reproduce the single-process 8-device run.
    from hipims_tpu.ops.boundaries import GriddedBoundary
    series = np.zeros((4, 2, 2))
    series[:, 1, 1] = 3600.0
    rain = GriddedBoundary(series=series, interval=600.0,
                           resolution=n * 2.0 / 2.0, offset_x=0.0,
                           offset_y=0.0, mass_flux=False, length=2400.0)
    domB = Domain(zb=np.zeros((n, n)), manning=0.02, dx=2.0, dy=2.0)
    domB.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
    cfgB = SimulationConfig(scheme="muscl-hancock", duration=3.0,
                            output_frequency=1.5, batch_size=2,
                            batch_auto=False, sync_method="forecast",
                            forecast_window=2)
    refB = Simulation(domB, cfgB, boundaries=(rain,), mesh=make_mesh(8))
    refB.run()
    assert float(res["tB"]) == pytest.approx(refB.t, abs=1e-9)
    np.testing.assert_allclose(res["zB"], np.asarray(refB.state.z),
                               rtol=1e-6, atol=1e-7)
    assert float(res["volB"]) == pytest.approx(refB.volume(), rel=1e-6)
    assert float(rank1["volB"]) == pytest.approx(float(res["volB"]),
                                                 rel=1e-12)
    # Rain fell (the NE-quadrant georeferencing was live on the cluster).
    assert float(res["volB"]) > float(res["vol"]) * 0.9
