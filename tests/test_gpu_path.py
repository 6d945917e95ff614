"""What decides and proves the GPU path, exercised on the CPU: kernel
backend choice, compile-cache placement, and chip_smoke.py's refusal to
run off the card and its phases at tiny sizes."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from hipims_tpu.runtime import Simulation, SimulationConfig
from hipims_tpu.utils import compile_cache
from tests.test_simulation import circular_dam_domain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sim(scheme="godunov", dtype="float32", backend="auto"):
    return Simulation(circular_dam_domain(n=16), SimulationConfig(
        scheme=scheme, dtype=dtype, kernel_backend=backend, duration=1.0,
        output_frequency=1.0))


@pytest.mark.parametrize("scheme,dtype", [
    ("godunov", "float32"), ("inertial", "float32c"),
    ("muscl-hancock", "float32")])
def test_auto_backend_off_gpu_is_xla(scheme, dtype):
    """The kernel is chosen only on a GPU; here every scheme runs XLA."""
    assert jax.devices()[0].platform == "cpu"
    assert _sim(scheme, dtype).backend == "xla"


def test_triton_backend_off_gpu_raises():
    """An explicit GPU kernel request never falls back (nor runs the
    interpreter) off the card."""
    with pytest.raises(ValueError, match="needs a GPU"):
        _sim(backend="triton")


@pytest.mark.parametrize("backend", ["pallas", "mosaic"])
def test_unknown_backend_rejected(backend):
    with pytest.raises(ValueError, match="kernel_backend"):
        _sim(backend=backend)


def test_compile_cache_default_dir(monkeypatch):
    """Unset JAX_COMPILATION_CACHE_DIR: the fixed <checkout>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    """Set JAX_COMPILATION_CACHE_DIR: that directory and no other."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    p = _smoke(REPO, "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "platform is gpu (found 'cpu')" in p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo beside it the script fails."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    p = _smoke(str(tmp_path), "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.fixture
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_smoke_device_phase_rejects_cpu(smoke):
    with pytest.raises(smoke.SmokeFailure):
        smoke.phase_device()


def test_smoke_step_seconds(smoke):
    """The timing helper runs real batches and returns a per-step time."""
    sim = _sim()
    per_step, raw = smoke.step_seconds(sim, n_steps=3, batches=2)
    assert len(raw) == 2 and 0.0 < per_step < max(raw)
    assert sim.total_steps == 0 and float(sim.carry.t) > 0.0


def test_smoke_end_to_end_phase(smoke, tmp_path):
    """Both deployments through the CLI at tiny size: rasters read back,
    the logged volumes checked."""
    smoke.phase_end_to_end(str(tmp_path), duration=20.0, outfreq=10.0,
                           small=True)


def test_smoke_correctness_phase(smoke, capsys):
    """Every scheme x precision against the CPU f64 reference (the
    'card' is the CPU here, so there is no kernel to compare)."""
    smoke.phase_correctness(n=24, steps=2, card=jax.devices("cpu")[0],
                            kernel=False)
    out = capsys.readouterr().out
    assert out.count("PASS correctness") == 9


def test_smoke_four_cards_phase(smoke, capsys):
    """The 2x2 mesh phase on four virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    smoke.phase_four_cards(n=64, duration=3.0, devices=jax.devices()[:4])
    out = capsys.readouterr().out
    assert out.count("PASS four-cards") == 7
    assert np.isfinite(float(out.split("volume=")[1].split()[0]))
