"""Generate the Newcastle full-field golden artifact.

Runs the reference's bundled newcastle-centre model (HFA DEM, rainfall +
drainage, Godunov, closed edges) for the full 7200 s in float64 on CPU and
stores the prognostic fields (z, qx, qy — depth is derived) at 7200 s as a
compressed npz, plus the 12-point volume trajectory.  The volume
trajectory is cross-checked against the existing JSON golden
(tests/data/newcastle_golden.json) so a regenerated artifact cannot
silently drift from the established trajectory.

Usage:  python tools/make_newcastle_golden.py [outdir]
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path


def main():
    import os
    os.environ.setdefault("JAX_PLATFORMS", "")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    repo = Path(__file__).resolve().parent.parent
    outdir = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        repo / "tests" / "data")
    ref = Path("/root/reference/test")
    work = Path(tempfile.mkdtemp(prefix="newcastle_golden_"))
    shutil.copy(ref / "newcastle-centre.xml", work)
    shutil.copytree(ref / "newcastle-centre", work / "newcastle-centre")

    from hipims_tpu.io.xml_config import load_config
    from hipims_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    model = load_config(work / "newcastle-centre.xml")
    # The loader maps the XML's "double" to compensated-f32 by default;
    # the golden must be the true-f64 path.
    model.config.dtype = "float64"
    sim = model.simulation()
    sim.output_writer = None

    old = json.loads((repo / "tests/data/newcastle_golden.json").read_text())
    volumes = {}
    for i in range(1, 13):
        t = i * 600.0
        sim.run_to(t)
        v = sim.volume()
        volumes[str(int(t))] = v
        drift = abs(v - old["volumes"][str(int(t))]) / v
        print(f"t={t:6.0f}  vol={v:.6f} m^3  drift_vs_old={drift:.2e}",
              flush=True)
        assert drift < 1e-6, "volume trajectory drifted from the committed golden"

    st = sim.state_logical
    zb = np.asarray(sim.static_logical.zb, np.float64)
    z = np.asarray(st.z, np.float64)
    h = sim.depth()
    outdir.mkdir(parents=True, exist_ok=True)
    vol_ts = sorted(int(k) for k in volumes)
    np.savez_compressed(
        outdir / "newcastle_golden_fields.npz",
        z=z, qx=np.asarray(st.qx, np.float64),
        qy=np.asarray(st.qy, np.float64),
        zmax=np.asarray(st.zmax, np.float64),
        zb=zb, datum=np.float64(sim.domain.datum), t=np.float64(sim.t),
        volume_times=np.asarray(vol_ts, np.float64),
        volumes=np.asarray([volumes[str(k)] for k in vol_ts], np.float64))
    print("fields npz:",
          (outdir / 'newcastle_golden_fields.npz').stat().st_size, "bytes")
    print("depth mean", h.mean(), "max", h.max(),
          "wet", int((h > 0.01).sum()))


if __name__ == "__main__":
    main()
