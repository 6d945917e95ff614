"""End-to-end run of the reference's bundled Newcastle model through the
XML config path (HFA DEM, rainfall + drainage atmospheric boundaries,
closed edges, Godunov, double precision)."""

import shutil
from pathlib import Path

import numpy as np
import pytest

REF_TEST = Path("/root/reference/test")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    if not (REF_TEST / "newcastle-centre.xml").exists():
        pytest.skip("reference test model not available")
    dst = tmp_path_factory.mktemp("newcastle")
    shutil.copy(REF_TEST / "newcastle-centre.xml", dst)
    shutil.copytree(REF_TEST / "newcastle-centre", dst / "newcastle-centre")
    return dst


def test_hfa_dem_matches_gdal_statistics():
    if not REF_TEST.exists():
        pytest.skip("reference test model not available")
    from hipims_tpu.io.hfa import read_hfa
    r = read_hfa(REF_TEST / "newcastle-centre/topography/"
                 "NewcastleCentreDEM_2m.img")
    # Values from the GDAL-written .aux.xml statistics.
    assert r.data.shape == (195, 342)
    assert r.cell_size == 2.0
    assert r.data.min() == pytest.approx(43.4375)
    assert r.data.max() == pytest.approx(81.737503, rel=1e-6)
    assert float(r.data.mean()) == pytest.approx(56.567615, rel=1e-6)
    assert r.xll == pytest.approx(424520.000122, abs=1e-5)
    assert r.yll == pytest.approx(565146.000122, abs=1e-5)


def test_newcastle_model_runs(model_dir):
    from hipims_tpu.io.xml_config import load_config

    model = load_config(model_dir / "newcastle-centre.xml")
    assert model.config.scheme == "godunov"
    assert model.config.duration == 7200.0
    # The XML says "double"; the loader maps that to compensated-f32 (the
    # f64-accuracy-class mode) with a logged notice — --precision double /
    # "double-strict" force true f64.
    assert model.config.dtype == "float32c"
    assert model.domain.rows == 195 and model.domain.cols == 342
    assert len(model.boundaries) == 2  # rainfall + drainage
    rain = [b for b in model.boundaries if not b.is_loss][0]
    drain = [b for b in model.boundaries if b.is_loss][0]
    assert rain.values[0] == 70.0
    assert drain.values[0] == 12.0
    # Closed edges from <domainEdge> (which the reference documents but
    # never parses — we honour it).
    assert all(v == "closed" for v in model.domain.edge_treatment.values())

    # Shortened run: 10 minutes of 70 mm/hr rain minus 12 mm/hr drainage.
    model.config.duration = 600.0
    model.config.output_frequency = 600.0
    sim = model.simulation()
    sim.run()

    assert sim.t == pytest.approx(600.0, abs=1e-4)
    h = sim.depth()
    assert np.isfinite(h).all()
    # Net accumulation ~ (70-12) mm/hr over ~10 min => ~9.7 mm average,
    # redistributed by flow; the hydrological gating loses the final
    # partial second.
    area = (sim.domain.rows - 2) * (sim.domain.cols - 2) * 4.0
    expected = (70.0 - 12.0) / 3.6e6 * 600.0 * area
    assert sim.volume() == pytest.approx(expected, rel=0.02)
    # Water must have concentrated somewhere (flow happened).
    assert h.max() > 0.02
    # Outputs written.
    outs = list((model_dir / "newcastle-centre/output").glob("*.img"))
    assert len(outs) == 5  # depth, velX, velY, fsl, maxdepth


@pytest.mark.slow
def test_newcastle_full_duration_golden(model_dir):
    """Full 7200 s regression against the committed golden artifacts
    (BASELINE.md target 3: per-cell allclose on the prognostic fields
    after 7200 s).  The goldens were produced by this framework's f64 CPU
    path (tests/data/newcastle_golden.json volume trajectory +
    newcastle_golden_fields.npz full h/qx/qy fields, regenerable with
    tools/make_newcastle_golden.py, which cross-checks the trajectory);
    any numerics change that moves the solution shows up here."""
    import json

    gold_path = Path(__file__).parent / "data" / "newcastle_golden.json"
    fields_path = (Path(__file__).parent / "data"
                   / "newcastle_golden_fields.npz")
    if not gold_path.exists() or not fields_path.exists():
        pytest.skip("golden artifact not generated yet")
    gold = json.loads(gold_path.read_text())

    from hipims_tpu.io.xml_config import load_config

    model = load_config(model_dir / "newcastle-centre.xml")
    model.config.dtype = "float64"      # goldens are the true-f64 path
    sim = model.simulation()
    sim.output_writer = None
    for i in range(1, 13):
        sim.run_to(i * 600.0)
        want = gold["volumes"][str(i * 600)]
        assert sim.volume() == pytest.approx(want, rel=1e-6), f"t={i*600}"

    h = sim.depth()
    assert float(h.mean()) == pytest.approx(gold["depth_mean"], rel=1e-6)
    assert float(h.max()) == pytest.approx(gold["depth_max"], rel=1e-4)
    assert int((h > 0.01).sum()) == pytest.approx(gold["wet_cells"], abs=5)

    # Per-cell allclose on the full prognostic fields (z, qx, qy) — a
    # systematic error pattern inside any region now fails outright.
    with np.load(fields_path) as gf:
        st = sim.state_logical
        np.testing.assert_allclose(np.asarray(st.z), gf["z"],
                                   rtol=0, atol=1e-6, err_msg="z")
        np.testing.assert_allclose(np.asarray(st.qx), gf["qx"],
                                   rtol=0, atol=1e-6, err_msg="qx")
        np.testing.assert_allclose(np.asarray(st.qy), gf["qy"],
                                   rtol=0, atol=1e-6, err_msg="qy")
        np.testing.assert_allclose(np.asarray(st.zmax), gf["zmax"],
                                   rtol=0, atol=1e-6, err_msg="zmax")


@pytest.mark.slow
def test_newcastle_f32c_field_level_accuracy(model_dir):
    """The papers' accuracy anchor, asserted at field level on the real
    model: 32-bit arithmetic must keep MEAN per-cell depth error below
    0.01 m (urban-flood-jhi tex:338-339 reports >0.1 m mean errors for
    plain f32 on a 10 m DEM; 64-bit is the reference's default for this
    reason).  The compensated-f32 mode runs the full 7200 s and is
    compared per cell against the committed f64 golden fields."""
    fields_path = (Path(__file__).parent / "data"
                   / "newcastle_golden_fields.npz")
    if not fields_path.exists():
        pytest.skip("golden artifact not generated yet")

    from hipims_tpu.io.xml_config import load_config

    model = load_config(model_dir / "newcastle-centre.xml")
    model.config.dtype = "float32c"
    sim = model.simulation()
    sim.output_writer = None
    sim.run_to(7200.0)
    assert sim.domain.datum == 43.0

    with np.load(fields_path) as gf:
        zb = gf["zb"]
        h64 = np.maximum(gf["z"] - zb, 0.0)
        h64[gf["zmax"] <= -9990.0] = 0.0
    h32c = sim.depth()

    dh = np.abs(h32c - h64)
    wet = (h64 > 0.01) | (h32c > 0.01)
    mean_err = float(dh[wet].mean())
    max_err = float(dh.max())
    vol_err = abs(h32c.sum() - h64.sum()) / h64.sum()
    print(f"\nf32c vs f64 @7200s: mean wet |dh|={mean_err:.2e} m, "
          f"max |dh|={max_err:.3f} m, volume err={vol_err:.2e}")
    # Papers' anchor: mean depth error < 0.01 m; max and volume errors
    # bounded too.  Measured: mean 1.5e-3, max 0.113 (two steep-pond-
    # edge cells trading water with opposite signs), volume 1.5e-4;
    # the bounds leave ~2x headroom while failing a real regression.
    assert mean_err < 0.01, f"mean wet-cell |dh| = {mean_err:.4f} m"
    assert max_err < 0.25, f"max |dh| = {max_err:.3f} m"
    assert vol_err < 5e-4, f"volume error {vol_err:.2e}"


def test_newcastle_compensated_tracks_f64_golden(model_dir):
    """The compensated-f32 mode on the REAL model (HFA DEM at a 43 m
    datum, rainfall + drainage boundaries): after 1200 s its water budget
    sits several times closer to the f64 golden trajectory than plain
    f32's (measured 0.014% vs 0.095% volume error)."""
    import json

    gold_path = Path(__file__).parent / "data" / "newcastle_golden.json"
    if not gold_path.exists():
        pytest.skip("golden artifact not generated yet")
    want = json.loads(gold_path.read_text())["volumes"]["1200"]

    from hipims_tpu.io.xml_config import load_config

    errs = {}
    for dtype in ("float32", "float32c"):
        model = load_config(model_dir / "newcastle-centre.xml")
        model.config.dtype = dtype
        sim = model.simulation()
        sim.output_writer = None
        sim.run_to(1200.0)
        assert sim.domain.datum == 43.0     # shift engaged on the real DEM
        errs[dtype] = abs(sim.volume() - want) / want

    assert errs["float32c"] < 5e-4          # f64-class budget
    assert errs["float32c"] < errs["float32"]
    assert errs["float32"] < 5e-3           # datum shift alone holds ~0.1%
