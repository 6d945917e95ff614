"""Checkpoint/resume, embedding API, and gridded-boundary config tests."""

import numpy as np
import pytest

from hipims_tpu.domain import Domain
from hipims_tpu.runtime import Simulation, SimulationConfig
from hipims_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint
from tests.test_simulation import circular_dam_domain


def _cfg(duration, **kw):
    return SimulationConfig(scheme="godunov", duration=duration,
                            output_frequency=duration, friction=False,
                            batch_size=8, batch_auto=False, **kw)


def test_checkpoint_resume_exact(tmp_path):
    """Checkpoint at t=2 then resume must equal continuing in memory.
    (A sync point at t=2 alters the dt sequence vs a straight 0->4 run —
    reference behaviour — so the baseline also pauses at 2.)"""
    a = Simulation(circular_dam_domain(n=48), _cfg(4.0))
    a.run_to(2.0)
    save_checkpoint(tmp_path / "ck.npz", a)
    a.run_to(4.0)

    b = Simulation(circular_dam_domain(n=48), _cfg(4.0))
    load_checkpoint(tmp_path / "ck.npz", b)
    assert float(b.carry.t) == pytest.approx(2.0, abs=1e-5)
    b.run_to(4.0)

    assert b.t == pytest.approx(a.t, abs=1e-9)
    for x, y, name in zip(a.state, b.state, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_checkpoint_rejects_mismatch(tmp_path):
    a = Simulation(circular_dam_domain(n=32), _cfg(1.0))
    save_checkpoint(tmp_path / "ck.npz", a)
    b = Simulation(circular_dam_domain(n=48), _cfg(1.0))
    with pytest.raises(ValueError, match="grid"):
        load_checkpoint(tmp_path / "ck.npz", b)


def test_embedding_api(tmp_path):
    from hipims_tpu.api import device_count, simulation_load
    from hipims_tpu.io.raster import Raster, write_raster

    write_raster(tmp_path / "dem.asc", Raster(np.zeros((16, 24)),
                                              cell_size=2.0))
    (tmp_path / "m.xml").write_text("""<?xml version="1.0"?>
    <configuration><metadata><name>API</name></metadata>
    <simulation>
      <parameter name="duration" value="5" />
      <parameter name="outputFrequency" value="5" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.3" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
        </data>
        <scheme name="Godunov" />
      </domain></domainSet></simulation></configuration>""")

    handle = simulation_load(tmp_path / "m.xml")
    info = handle.domain_info()
    assert (info.rows, info.cols) == (16, 24)
    assert info.resolution == 2.0
    handle.launch(blocking=True)
    assert handle.progress == pytest.approx(1.0, abs=1e-4)
    depth = handle.field("depth")
    assert depth.shape == (16, 24)
    assert device_count() >= 1
    handle.close()


def test_output_time_labels_no_collision(tmp_path):
    """Sub-second output frequencies must produce distinct %t filenames
    (int() truncation used to collide 0.5 s and 1.0 s onto '0'/'1')."""
    from hipims_tpu.runtime.output import RasterOutputWriter
    from hipims_tpu.utils import time_label

    assert time_label(10.0) == "10"
    assert time_label(1.5) == "1.5"
    assert time_label(0.5) != time_label(1.0)

    sim = Simulation(circular_dam_domain(n=16), _cfg(1.0))
    writer = RasterOutputWriter(
        [{"value": "depth", "format": "asc", "target": "d_%t.asc"}],
        str(tmp_path), sim.domain)
    for t in (0.5, 1.0, 1.5):
        writer(sim, t)
    made = {p.name for p in tmp_path.glob("d_*.asc")}
    assert made == {"d_0.5.asc", "d_1.asc", "d_1.5.asc"}


def test_progress_rate_spans_all_batches():
    """The printed Mcells/s must divide the steps since the last print by
    the elapsed time of *all* batches in the window, not just the batch
    that triggered the print."""
    from hipims_tpu.runtime.progress import ProgressReporter

    class FakeLog:
        def __init__(self):
            self.lines = []

        def line(self, msg):
            self.lines.append(msg)

        def block(self, msg):
            pass

    class FakeDomain:
        cell_count = 2_000_000

    class FakeSim:
        domain = FakeDomain()
        config = _cfg(100.0)
        total_steps = 0
        total_skipped = 0
        _batch_size = 8
        t = 0.0

    log, sim = FakeLog(), FakeSim()
    rep = ProgressReporter(log, sim, interval=1e9)
    # Two 1-second batches of 50 steps land before the print fires.
    sim.total_steps = 50
    rep(sim, 10.0, 1.0)
    assert not log.lines
    sim.total_steps = 100
    rep.interval = 0.0          # force the next call to print
    rep(sim, 20.0, 1.0)
    assert len(log.lines) == 1
    # 100 steps * 2 Mcells over 2.0 s = 100.0 Mcells/s (200.0 if only the
    # triggering batch's elapsed were used).
    assert " 100.0 Mcells/s" in log.lines[0]


def test_friction_never_reverses_flow():
    """One-ulp guard: friction output never carries the opposite sign of
    the input discharge, for awkward (non-power-of-two) dt values."""
    import jax.numpy as jnp

    from hipims_tpu.ops.friction import implicit_friction

    rng = np.random.default_rng(7)
    n = 512
    zb = jnp.zeros(n)
    z = jnp.asarray(rng.uniform(1e-6, 2.0, n))
    qx = jnp.asarray(rng.uniform(-5.0, 5.0, n))
    qy = jnp.asarray(rng.uniform(-5.0, 5.0, n))
    for dt in (0.1, 0.3, 0.7, 1e-3, 2.3e-2):
        qxn, qyn = implicit_friction(z, qx, qy, zb, 0.05, dt, 1e-10)
        assert not np.any(np.asarray(qxn) * np.asarray(qx) < 0.0)
        assert not np.any(np.asarray(qyn) * np.asarray(qy) < 0.0)


def test_gridded_boundary_from_config(tmp_path):
    """Radar-rainfall rasters via a strftime mask + realStart."""
    from hipims_tpu.io.raster import Raster, write_raster
    from hipims_tpu.io.xml_config import load_config

    (tmp_path / "bdy").mkdir()
    write_raster(tmp_path / "dem.asc", Raster(np.zeros((20, 20)),
                                              cell_size=2.0))
    # Three hourly radar frames at 10x10 4m cells, increasing rates.
    for i, stamp in enumerate(["200001010000", "200001010100",
                               "200001010200"]):
        write_raster(tmp_path / "bdy" / f"radar_{stamp}.asc",
                     Raster(np.full((10, 10), 10.0 * (i + 1)),
                            cell_size=4.0))

    (tmp_path / "m.xml").write_text("""<?xml version="1.0"?>
    <configuration><metadata><name>Radar</name></metadata>
    <simulation>
      <parameter name="duration" value="7200" />
      <parameter name="outputFrequency" value="7200" />
      <parameter name="realStart" value="2000-01-01 00:00:00"
                 format="%Y-%m-%d %H:%M:%S" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.0" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
        </data>
        <scheme name="Godunov" />
        <boundaryConditions sourceDir="bdy/">
          <timeseries type="gridded" name="Radar" value="rain-intensity"
                      mask="radar_%Y%m%d%H%M.asc" interval="3600" />
        </boundaryConditions>
      </domain></domainSet></simulation></configuration>""")

    model = load_config(tmp_path / "m.xml")
    assert len(model.boundaries) == 1
    b = model.boundaries[0]
    assert b.series.shape == (3, 10, 10)
    assert b.series[1, 0, 0] == 20.0
    assert b.interval == 3600.0

    sim = model.simulation()
    sim.run_to(60.0)
    # ~1 min of 10 mm/hr rain on the interior.
    area = 18 * 18 * 4.0
    expected = 10.0 / 3.6e6 * 60.0 * area
    assert sim.volume() == pytest.approx(expected, rel=0.05)


def test_divergence_raises():
    """A NaN in the state surfaces as a clear error, not an endless spin
    (reference: isSimulationFailure, CSchemeGodunov.cpp:1523-1555)."""
    import jax.numpy as jnp
    import pytest

    sim = Simulation(circular_dam_domain(n=32), _cfg(10.0))
    z = np.asarray(sim.state.z).copy()
    z[16, 16] = np.nan
    sim.state = sim.state._replace(z=jnp.asarray(z))
    with pytest.raises(RuntimeError, match="diverged"):
        sim.run()


def test_embedding_api_callbacks(tmp_path):
    """Push-style callbacks (the reference DLL's visualisation surface):
    on_progress fires per batch, on_output at every output time with the
    fields fetchable inside the callback."""
    from hipims_tpu.api import simulation_load
    from hipims_tpu.io.raster import Raster, write_raster

    write_raster(tmp_path / "dem.asc", Raster(np.zeros((16, 24)),
                                              cell_size=2.0))
    (tmp_path / "m.xml").write_text("""<?xml version="1.0"?>
    <configuration><metadata><name>CB</name></metadata>
    <simulation>
      <parameter name="duration" value="4" />
      <parameter name="outputFrequency" value="2" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.3" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
          <dataTarget type="raster" value="depth" format="GTiff"
                      target="depth_%t.tif" />
        </data>
        <scheme name="Godunov" />
      </domain></domainSet></simulation></configuration>""")

    frames, ticks = [], []
    handle = simulation_load(tmp_path / "m.xml")
    handle.on_output(lambda h, t: frames.append((t, h.field("depth"))))
    handle.on_progress(lambda h, t, el: ticks.append(t))
    handle.launch(blocking=True)

    assert [t for t, _ in frames] == [2.0, 4.0]
    assert all(f.shape == (16, 24) for _, f in frames)
    assert len(ticks) >= 1
    # File outputs still written alongside the callbacks.
    outs = sorted(p.name for p in (tmp_path / "out").glob("*.tif"))
    assert outs == ["depth_2.tif", "depth_4.tif"]
    handle.close()


def test_gridded_series_gap_and_end_gating(tmp_path):
    """A missing mid-series frame STOPS the series
    (no silent one-interval shift of later frames), and past the
    truncated length the boundary applies nothing (the reference instead
    clamps to an out-of-bounds index and rains the last frame forever,
    src/Boundaries/CLBoundaries.clc:229-230)."""
    import jax.numpy as jnp

    from hipims_tpu.io.raster import Raster, write_raster
    from hipims_tpu.io.xml_config import load_config

    (tmp_path / "bdy").mkdir()
    write_raster(tmp_path / "dem.asc", Raster(np.zeros((20, 20)),
                                              cell_size=2.0))
    # Frames at t=0 and t=3600; t=7200 MISSING; t=10800 present again —
    # the loader must keep exactly two frames and set length=7200.
    for i, stamp in enumerate(["200001010000", "200001010100",
                               "200001010300"]):
        write_raster(tmp_path / "bdy" / f"radar_{stamp}.asc",
                     Raster(np.full((10, 10), 10.0 * (i + 1)),
                            cell_size=4.0))

    (tmp_path / "m.xml").write_text("""<?xml version="1.0"?>
    <configuration><metadata><name>Gap</name></metadata>
    <simulation>
      <parameter name="duration" value="14400" />
      <parameter name="outputFrequency" value="14400" />
      <parameter name="realStart" value="2000-01-01 00:00:00"
                 format="%Y-%m-%d %H:%M:%S" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.0" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
        </data>
        <scheme name="Godunov" />
        <boundaryConditions sourceDir="bdy/">
          <timeseries type="gridded" name="Radar" value="rain-intensity"
                      mask="radar_%Y%m%d%H%M.asc" interval="3600" />
        </boundaryConditions>
      </domain></domainSet></simulation></configuration>""")

    model = load_config(tmp_path / "m.xml")
    b = model.boundaries[0]
    # Truncated at the gap: two frames, NOT three (the 0300 frame would
    # have landed one interval early under the old `continue`).
    assert b.series.shape[0] == 2
    assert b.length == 7200.0

    # Past the truncated length the boundary is off: apply at t=7300
    # with a live hydrological accumulator must change nothing.
    sim = model.simulation()
    st = sim.state
    out = b.apply(st, sim.static, jnp.asarray(7300.0, sim.dtype),
                  jnp.asarray(1.0, sim.dtype),
                  jnp.asarray(2.0, sim.dtype), sim.params)
    np.testing.assert_array_equal(np.asarray(out.z), np.asarray(st.z))
    # ...while inside the series it does rain.
    out2 = b.apply(st, sim.static, jnp.asarray(100.0, sim.dtype),
                   jnp.asarray(1.0, sim.dtype),
                   jnp.asarray(2.0, sim.dtype), sim.params)
    assert float(np.abs(np.asarray(out2.z) - np.asarray(st.z)).max()) > 0
