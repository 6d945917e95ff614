"""Streamed (bounded-memory) output/checkpoint I/O.

The streamed path must produce byte-identical raster files and
np.load-identical checkpoints versus the full-gather path, while never
materialising the full grid on any host (runtime/sharded_io.py).
"""

import os

import numpy as np
import pytest

import jax

from hipims_tpu.domain import Domain
from hipims_tpu.parallel import make_mesh
from hipims_tpu.runtime import Simulation, SimulationConfig
from hipims_tpu.runtime.sharded_io import (chunk_rows_for,
                                           stream_global_rows)


def _build(n=96, mesh=None, io_mode="gather", dtype="float32",
           writer=None):
    zb = np.zeros((n, n))
    dom = Domain(zb=zb, manning=0.02, dx=2.0, dy=2.0)
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
    dom.set_initial_depth(np.where(r <= n / 2.5, 1.5, 0.1))
    cfg = SimulationConfig(scheme="godunov", duration=8.0,
                           output_frequency=4.0, dtype=dtype,
                           batch_size=8, batch_auto=False, io_mode=io_mode)
    return Simulation(dom, cfg, mesh=mesh, output_writer=writer)


def test_stream_global_rows_roundtrip():
    """Chunks re-assemble to the exact array, forward and reverse, on an
    8-device sharded grid."""
    from hipims_tpu.parallel.mesh import shard_simulation_arrays
    sim = _build(mesh=make_mesh(8))
    want = np.asarray(sim.state.z)
    for reverse in (False, True):
        got = np.empty_like(want)
        rows_seen = []
        for r0, chunk in stream_global_rows(sim.state.z, 40,
                                            reverse=reverse):
            assert chunk.shape[0] <= 40
            got[r0:r0 + chunk.shape[0]] = chunk
            rows_seen.append(r0)
        np.testing.assert_array_equal(got, want)
        assert rows_seen == sorted(rows_seen, reverse=reverse)


def test_chunk_rows_budget():
    # 6 fields x 4 B x cols per row; budget respected, 8-aligned.
    rows = chunk_rows_for(100_000, n_fields=6, budget_mb=64)
    assert rows % 8 == 0
    assert rows * 100_000 * 4 * 6 <= 64 << 20
    assert chunk_rows_for(10, n_fields=1) >= 8


@pytest.mark.parametrize("mesh_n", [None, 8])
def test_streamed_rasters_match_gathered_bytes(tmp_path, mesh_n):
    """The done-condition: streamed writer output is
    byte-identical to the gathered writer (TIFF and ASC), under both the
    single-device and 8-device-mesh layouts."""
    from hipims_tpu.runtime.output import RasterOutputWriter

    outs = {}
    for mode in ("gather", "stream"):
        d = tmp_path / mode
        writer = RasterOutputWriter(
            [dict(value="depth", format="tif", target="depth_%t.tif"),
             dict(value="fsl", format="asc", target="fsl_%t.asc"),
             dict(value="velocityx", format="tif", target="vx_%t.tif")],
            str(d), None)
        mesh = make_mesh(mesh_n) if mesh_n else None
        sim = _build(mesh=mesh, io_mode=mode, writer=writer)
        writer.domain = sim.domain
        sim.run()
        outs[mode] = {p.name: p.read_bytes() for p in d.iterdir()}

    assert set(outs["gather"]) == set(outs["stream"])
    assert len(outs["gather"]) == 6            # 3 targets x 2 events
    for name in outs["gather"]:
        assert outs["gather"][name] == outs["stream"][name], name


def test_streamed_checkpoint_matches_and_resumes(tmp_path):
    """Streamed checkpoints hold identical arrays to gathered ones and
    resume bit-exactly."""
    from hipims_tpu.runtime.checkpoint import load_checkpoint, \
        save_checkpoint
    from hipims_tpu.runtime.simulation import _OutputSnapshot, \
        _StreamingSnapshot

    sim = _build(dtype="float32c", io_mode="stream")
    sim.run_to(4.0)
    save_checkpoint(tmp_path / "g.npz", sim, snapshot=_OutputSnapshot(sim))
    save_checkpoint(tmp_path / "s.npz", sim,
                    snapshot=_StreamingSnapshot(sim))

    with np.load(tmp_path / "g.npz") as g, np.load(tmp_path / "s.npz") as s:
        assert set(g.files) == set(s.files)
        for k in g.files:
            if k == "meta":
                assert str(g[k]) == str(s[k])
            else:
                np.testing.assert_array_equal(g[k], s[k], err_msg=k)

    # Resume from the streamed file and continue; compare with an
    # uninterrupted run.
    sim2 = _build(dtype="float32c", io_mode="stream")
    load_checkpoint(tmp_path / "s.npz", sim2)
    sim2.run_to(8.0)
    ref = _build(dtype="float32c")
    ref.run_to(4.0)         # same sync landing as the checkpointed run
    ref.run_to(8.0)
    np.testing.assert_array_equal(np.asarray(sim2.state.z),
                                  np.asarray(ref.state.z))


def test_streaming_snapshot_guards_and_volume():
    from hipims_tpu.runtime.output import domain_volume
    from hipims_tpu.runtime.simulation import _StreamingSnapshot

    sim = _build(io_mode="stream")
    sim.run_to(4.0)
    snap = _StreamingSnapshot(sim)
    with pytest.raises(AttributeError, match="streaming"):
        snap.state_logical
    v_stream = domain_volume(snap, sim.domain)
    v_gather = sim.volume()
    assert v_stream == pytest.approx(v_gather, rel=1e-6)


def test_streamed_gauge_rows_match_gathered(tmp_path):
    from hipims_tpu.runtime.output import GaugeOutputWriter

    rows = {}
    for mode in ("gather", "stream"):
        sim = _build(io_mode=mode)
        gauges = [(40.0, 40.0, "G1"), (96.0, 100.0, "G2")]
        w = GaugeOutputWriter("depth", gauges,
                              tmp_path / f"gauges_{mode}.csv", sim.domain)
        sim.output_writer = w
        sim.run()
        rows[mode] = (tmp_path / f"gauges_{mode}.csv").read_text()
    assert rows["gather"] == rows["stream"]


@pytest.mark.slow
def test_large_grid_smoke_streams_within_budget(tmp_path):
    """8192^2 (67 M cells — above the auto threshold): one output event
    writes a valid compressed raster + checkpoint through the streamed
    path; the chunk budget bounds per-event host traffic to
    io_chunk_mb."""
    from hipims_tpu.io.raster import read_raster
    from hipims_tpu.runtime.output import RasterOutputWriter

    n = 8192
    zb = np.zeros((n, n), np.float32)
    dom = Domain(zb=zb, manning=0.0, dx=2.0, dy=2.0)
    dom.set_initial_depth(np.full((n, n), 0.25, np.float32))
    writer = RasterOutputWriter(
        [dict(value="depth", format="tif", target="d_%t.tif")],
        str(tmp_path), dom)
    cfg = SimulationConfig(scheme="godunov", duration=1.0,
                           output_frequency=1.0, batch_size=1,
                           batch_auto=False, io_chunk_mb=32)
    sim = Simulation(dom, cfg, output_writer=writer)
    assert sim.io_streaming()           # auto mode picked the stream path
    sim.checkpoint_path = str(tmp_path / "ck.npz")
    sim.emit_output(0.0)
    r = read_raster(tmp_path / "d_0.tif")
    assert r.data.shape == (n, n)
    assert abs(float(r.data[n // 2, n // 2]) - 0.25) < 1e-6
    with np.load(tmp_path / "ck.npz") as ck:
        assert ck["z"].shape == (sim.domain.rows, sim.domain.cols)
    # Compressed: far below the 268 MB uncompressed plane.
    assert os.path.getsize(tmp_path / "d_0.tif") < 40 << 20


def test_api_field_on_streamed_snapshot(tmp_path):
    """handle.field(...) inside an on_output callback must work with the
    streamed snapshot (single-process): the derived field assembles from
    bounded chunks and matches the gathered computation."""
    from hipims_tpu.io.raster import Raster, write_raster

    write_raster(tmp_path / "dem.asc",
                 Raster(np.zeros((48, 64)), cell_size=2.0))
    (tmp_path / "m.xml").write_text("""<?xml version="1.0"?>
    <configuration><metadata><name>F</name></metadata>
    <simulation>
      <parameter name="duration" value="4" />
      <parameter name="outputFrequency" value="2" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.3" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
        </data>
        <scheme name="Godunov" />
      </domain></domainSet></simulation></configuration>""")

    from hipims_tpu.api import simulation_load

    h = simulation_load(tmp_path / "m.xml")
    h.simulation.config.io_mode = "stream"
    got = {}

    def cb(handle, t):
        got[t] = handle.field("depth")

    h.on_output(cb).launch(blocking=True)
    assert set(got) == {2.0, 4.0}
    want = h.field("depth")              # post-run, non-snapshot path
    assert got[4.0].shape == (48, 64)
    np.testing.assert_allclose(got[4.0], want, rtol=1e-6, atol=1e-9)


def test_io_mode_from_xml(tmp_path):
    """<parameter name="ioMode" value="stream"> (framework extension)
    selects the streamed output path from the config file."""
    from hipims_tpu.io.raster import Raster, write_raster
    from hipims_tpu.io.xml_config import load_config

    write_raster(tmp_path / "dem.asc", Raster(np.zeros((16, 16)),
                                              cell_size=2.0))
    (tmp_path / "m.xml").write_text("""<?xml version="1.0"?>
    <configuration><metadata><name>IO</name></metadata>
    <simulation>
      <parameter name="duration" value="2" />
      <parameter name="outputFrequency" value="2" />
      <parameter name="ioMode" value="stream" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.1" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
          <dataTarget type="raster" value="depth" format="GTiff"
                      target="d_%t.tif" />
        </data>
        <scheme name="Godunov" />
      </domain></domainSet></simulation></configuration>""")
    model = load_config(tmp_path / "m.xml")
    assert model.config.io_mode == "stream"
    sim = model.simulation()
    assert sim.io_streaming()
    sim.run()
    assert (tmp_path / "out" / "d_2.tif").exists()
