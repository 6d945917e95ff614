"""The XLA mesh paths (per-step GSPMD halos and halo-deep forecast
windows) against the single-device run, for the cases beyond
tests/test_sharding.py: single precision and its compensated mode, and
position-dependent forcing under every scheme."""

import jax
import numpy as np
import pytest

from hipims_tpu.domain import Domain
from hipims_tpu.parallel import make_mesh
from hipims_tpu.runtime import Simulation, SimulationConfig
from tests.test_sharding import _inflow_cells, _ne_quadrant_rain
from tests.test_simulation import circular_dam_domain


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _run(dom, mesh, scheme, dtype, sync="timestep", window=1,
         boundaries=(), duration=1.0):
    cfg = SimulationConfig(scheme=scheme, duration=duration,
                           output_frequency=duration, friction=True,
                           batch_size=4, batch_auto=False, dtype=dtype,
                           sync_method=sync, forecast_window=window)
    sim = Simulation(dom, cfg, boundaries=boundaries, mesh=mesh)
    sim.run()
    return sim


def _flat(n=64):
    dom = Domain(zb=np.zeros((n, n)), manning=0.03, dx=2.0, dy=2.0)
    dom.set_initial_depth(0.0)
    return dom


@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock", "inertial"])
def test_mesh_f32_matches_single_device(scheme, mesh8):
    """f32 on the 8-device GSPMD mesh == the single-device f32 run, to
    f32 fusion-order ulps."""
    ref = _run(circular_dam_domain(n=64), None, scheme, "float32")
    shd = _run(circular_dam_domain(n=64), mesh8, scheme, "float32")
    assert shd.backend == "xla"
    assert shd.t == pytest.approx(ref.t, rel=1e-6)
    for x, y, name in zip(ref.state_logical, shd.state_logical,
                          ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("sync,window", [("timestep", 1), ("forecast", 3)])
def test_mesh_compensated_matches_single_device(sync, window, mesh8):
    """float32c under the mesh: the residue plane rides the halo exchange
    (forecast windows) or the GSPMD shifts (timestep) and reproduces the
    single-device true surface z + comp."""
    ref = _run(circular_dam_domain(n=64), None, "godunov", "float32c")
    shd = _run(circular_dam_domain(n=64), mesh8, "godunov", "float32c",
               sync=sync, window=window)
    assert shd.compensated and shd._mesh_window == window
    assert float(np.abs(np.asarray(shd.comp)).max()) > 0.0
    true = [np.asarray(s.state.z, np.float64) + np.asarray(s.comp)
            for s in (ref, shd)]
    np.testing.assert_allclose(true[1], true[0], rtol=1e-6, atol=1e-6)
    assert shd.volume() == pytest.approx(ref.volume(), rel=1e-6)


@pytest.mark.parametrize("sync,window", [("timestep", 1), ("forecast", 3)])
@pytest.mark.parametrize("scheme", ["muscl-hancock", "inertial"])
def test_gridded_rain_mesh_other_schemes(scheme, sync, window, mesh8):
    """Gridded radar rain, georeferenced in global coordinates, under the
    radius-2 MUSCL stencil and the inertial scheme (f64: exact)."""
    n = 64
    rain = (_ne_quadrant_rain(n, 2.0),)
    ref = _run(_flat(n), None, scheme, "float64", boundaries=rain,
               duration=20.0)
    shd = _run(_flat(n), mesh8, scheme, "float64", sync=sync, window=window,
               boundaries=rain, duration=20.0)
    assert ref.volume() > 0.0
    assert shd.volume() == pytest.approx(ref.volume(), rel=1e-12)
    np.testing.assert_allclose(np.asarray(shd.state.z),
                               np.asarray(ref.state.z), rtol=1e-12,
                               atol=1e-12)
    d = shd.depth()
    assert d[n // 2:, n // 2:].sum() > 0.98 * d.sum() > 0.0


@pytest.mark.parametrize("sync,window", [("timestep", 1), ("forecast", 3)])
def test_cell_inflow_mesh_muscl(sync, window, mesh8):
    """A line of cell-boundary sources crossing every block row, scattered
    by global index under the MUSCL stencil."""
    n = 64
    cells = (_inflow_cells(n),)
    ref = _run(_flat(n), None, "muscl-hancock", "float64",
               boundaries=cells, duration=6.0)
    shd = _run(_flat(n), mesh8, "muscl-hancock", "float64", sync=sync,
               window=window, boundaries=cells, duration=6.0)
    assert ref.volume() > 0.0
    assert shd.volume() == pytest.approx(ref.volume(), rel=1e-12)
    np.testing.assert_allclose(np.asarray(shd.state.z),
                               np.asarray(ref.state.z), rtol=1e-12,
                               atol=1e-12)
