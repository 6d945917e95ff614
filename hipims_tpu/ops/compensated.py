"""Compensated single-precision accumulation for the free-surface level.

The reference's headline scientific finding is that 32-bit arithmetic is
insufficient for flood modelling: per-step free-surface increments
(``dt * flux_divergence`` ~ 1e-4 m, rainfall ~ 1e-6 m per hydrological
step) fall below the float32 ulp of an absolute elevation riding a real
datum (ulp(100 m) ~ 7.6e-6 m), so updates are partially or wholly absorbed
— the papers measure >0.1 m mean depth errors and broken mass conservation,
and force 64-bit as the default (reference:
src/OpenCL/Executors/COCLProgram.cpp:359-406 precision switch;
docs/papers/urban-flood-jhi "Paper Normal Style.tex":271, 338-339).

The answer here is an error-free transformation in single precision
rather than 64-bit arithmetic: the prognostic ``z`` carries a
compensation plane ``comp`` holding the rounding residue of its running
sum (Neumaier/Kahan).  The visible float32 ``z`` stays the correctly
rounded value every kernel already consumes — fluxes, wet/dry masks,
outputs are untouched — while ``z + comp`` tracks the true surface to
~ulp(increment) instead of a random walk of ulp(z) per step:

    y     = delta + comp          # increment + residue: both tiny, exact
    z'    = z + y                 # one rounding, error e = y - (z' - z)
    comp' = y - (z' - z)          # Fast2Sum residue (|z| >= |y| here)

Cost: one extra (rows, cols) float32 plane (+8 B/cell of device-memory
traffic in a fused step: 48 B/cell against 40 for plain f32) and three
adds — versus the reference's 2-3x slowdown for 64-bit on its GPUs
(BASELINE.md: 556 -> 159 M cells/s).  Whether native f64 on the GPU costs
less is measured, not assumed (ROADMAP).  The momentum
components are NOT compensated: their per-step increments are orders of
magnitude closer to their magnitudes (|q| ~ 0.1-10, dq ~ 1e-3-1e-1), and
point-implicit friction re-damps them every step, so no comparable random
walk develops — validated against the float64 oracle in
tests/test_compensated.py.
"""

from __future__ import annotations

import jax.numpy as jnp


def comp_add(z, comp, delta):
    """Neumaier-compensated ``z += delta`` -> (z_new, comp_new).

    ``z`` is the visible running sum, ``comp`` its rounding residue,
    ``delta`` the per-step increment.  The Fast2Sum residue is exact when
    |z| >= |y| (an elevation versus a per-step increment); where that is
    violated (z ~ 0) the dropped term is O(ulp(y)) — far below any
    physical threshold.
    """
    y = delta + comp
    z_new = z + y
    return z_new, y - (z_new - z)
