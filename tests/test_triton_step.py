"""The GPU first-order kernel (ops/triton_step.py) against the XLA step.

On the CPU the kernel runs through the Pallas interpreter; the ``gpu``
tests compile it for the card and skip elsewhere."""

import numpy as np
import pytest

from hipims_tpu.models import get_scheme
from hipims_tpu.ops.godunov import SchemeParams
from hipims_tpu.ops.timestep import max_wave_speed
from hipims_tpu.ops.triton_step import supports, triton_step
from hipims_tpu.state import DomainStatic, FlowState
from tests.test_godunov_oracle import random_domain

PARAMS = SchemeParams(dx=2.0, dy=2.0)


def _f32_domain(seed, rows=37, cols=70):
    """A ragged (non-power-of-two) f32 grid with dry and disabled cells."""
    z, zmax, qx, qy, zb, n = random_domain(seed, rows=rows, cols=cols)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (FlowState(f32(z), f32(zmax), f32(qx), f32(qy)),
            DomainStatic(zb=f32(zb), manning=f32(n)))


def _steps(scheme, state, static, n_steps, compensated, kernel, **kw):
    """``n_steps`` steps by the kernel (interpret mode) or the XLA step;
    returns (state, comp, last max speed)."""
    sch = get_scheme(scheme)
    dt = np.float32(0.02)
    comp = np.zeros_like(np.asarray(state.z)) if compensated else None
    speed = None
    for _ in range(n_steps):
        if kernel:
            out = triton_step(scheme, state, static, dt, PARAMS,
                              sch.simplified_speed, comp=comp,
                              interpret=True, **kw)
            state, speed = out[:2]
            comp = out[2] if compensated else None
        else:
            out = sch.step(state, static, dt, PARAMS, comp=comp) \
                if compensated else sch.step(state, static, dt, PARAMS)
            state, comp = out if compensated else (out, None)
            speed = max_wave_speed(*state, static.zb, PARAMS.quite_small,
                                   sch.simplified_speed)
    return state, comp, speed


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["float32", "float32c"])
@pytest.mark.parametrize("scheme", ["godunov", "inertial"])
def test_kernel_matches_xla_step(scheme, compensated):
    """Same arithmetic as the XLA step: agreement to a few f32 ulps after
    several steps on a ragged grid (ring and ragged edges masked)."""
    state, static = _f32_domain(11)
    got, got_c, _ = _steps(scheme, state, static, 3, compensated, True)
    want, want_c, _ = _steps(scheme, state, static, 3, compensated, False)
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # The static ring is never touched.
    for g, w in zip(got, state):
        g, w = np.asarray(g), np.asarray(w)
        for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_array_equal(g[edge], w[edge])
    if compensated:
        true_g = np.asarray(got.z, np.float64) + np.asarray(got_c)
        true_w = np.asarray(want.z, np.float64) + np.asarray(want_c)
        np.testing.assert_allclose(true_g, true_w, rtol=1e-6, atol=1e-6)


def test_block_shapes_give_identical_results():
    """Blocks share nothing, so the block shape cannot change a cell."""
    state, static = _f32_domain(3)
    a, _, sa = _steps("godunov", state, static, 2, True, True,
                      block=(8, 64), num_warps=4)
    b, _, sb = _steps("godunov", state, static, 2, True, True,
                      block=(4, 16), num_warps=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert float(sa) == float(sb)


@pytest.mark.parametrize("scheme", ["godunov", "inertial"])
def test_cfl_partials_match_max_wave_speed(scheme):
    """The per-block CFL partials, reduced outside the kernel, equal the
    XLA reduction over the kernel's own new state."""
    state, static = _f32_domain(5)
    sch = get_scheme(scheme)
    new, speed = triton_step(scheme, state, static, np.float32(0.02),
                             PARAMS, sch.simplified_speed, interpret=True)
    want = max_wave_speed(*new, static.zb, PARAMS.quite_small,
                          sch.simplified_speed)
    assert float(want) > 0.0
    assert float(speed) == pytest.approx(float(want), rel=1e-6)


def test_kernel_scope():
    """First-order schemes in f32 only; MUSCL stays on XLA."""
    assert supports("godunov", np.float32) and supports("inertial",
                                                        np.float32)
    assert not supports("muscl-hancock", np.float32)
    assert not supports("godunov", np.float64)
    state, static = _f32_domain(1, rows=12, cols=12)
    with pytest.raises(ValueError, match="no GPU kernel"):
        triton_step("muscl-hancock", state, static, 0.01, PARAMS,
                    interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["godunov", "inertial"])
def test_compiled_kernel_matches_xla_step(scheme, gpu_device):
    """The kernel as compiled for the card against the XLA step there."""
    import jax

    state, static = _f32_domain(7, rows=333, cols=517)
    with jax.default_device(gpu_device):
        sch = get_scheme(scheme)
        got, speed = triton_step(scheme, state, static, np.float32(0.02),
                                 PARAMS, sch.simplified_speed)
        want = sch.step(state, static, np.float32(0.02), PARAMS)
        want_speed = max_wave_speed(*want, static.zb, PARAMS.quite_small,
                                    sch.simplified_speed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-5)
