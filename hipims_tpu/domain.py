"""Cartesian domain: geometry, static fields, initial state, edge treatment.

The equivalent of CDomainCartesian (reference:
src/Domain/Cartesian/CDomainCartesian.cpp): a raster grid with bed
elevation, Manning roughness, disabled-cell masking via the -9999 sentinel,
and closed/open edge handling by raising a 9999.9 wall on the never-updated
edge ring (reference: CDomainCartesian.cpp:773-799 imposeBoundaryModification).

Unlike the reference (which leaves ``<domainEdge>`` parsing unimplemented and
relies on uninitialised defaults), edges here are explicitly 'closed' unless
configured 'open'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import constants as C
from .state import DomainStatic, FlowState, make_initial_state

EDGES = ("north", "east", "south", "west")


@dataclasses.dataclass
class Domain:
    """Host-side description of one Cartesian simulation domain."""

    zb: np.ndarray                       # bed elevation (rows, cols)
    manning: np.ndarray
    dx: float
    dy: float
    xll: float = 0.0                     # lower-left corner (world coords)
    yll: float = 0.0
    active: Optional[np.ndarray] = None  # False = disabled (-9999) cells
    edge_treatment: dict = dataclasses.field(
        default_factory=lambda: {e: "closed" for e in EDGES})

    # Initial conditions (set via set_initial_*)
    _depth: Optional[np.ndarray] = None
    _fsl: Optional[np.ndarray] = None
    _qx: Optional[np.ndarray] = None
    _qy: Optional[np.ndarray] = None

    def __post_init__(self):
        self.zb = np.asarray(self.zb, dtype=np.float64)
        if self.manning is None:
            self.manning = np.zeros_like(self.zb)
        elif np.isscalar(self.manning):
            self.manning = np.full_like(self.zb, float(self.manning))
        else:
            self.manning = np.asarray(self.manning, dtype=np.float64)
        if self.active is None:
            # NODATA bed cells are disabled, as in the reference's
            # handleInputData (src/Domain/CDomain.cpp:294-397).
            self.active = self.zb > C.NODATA + 0.5
        # Logical grid dimensions (the extent the scheme's static ring and
        # boundary forcing are measured from).
        self.logical_rows, self.logical_cols = self.zb.shape
        # Vertical datum removed from device-side elevations (set by
        # build(datum_shift=True); 0 until then).
        self.datum = 0.0
        # Pristine bed snapshot: initial conditions always evaluate against
        # this, making build() idempotent even after edge walls are raised.
        self._zb0 = self.zb.copy()

    @property
    def rows(self):
        return self.zb.shape[0]

    @property
    def cols(self):
        return self.zb.shape[1]

    @property
    def cell_count(self):
        return self.zb.size

    def set_initial_depth(self, depth):
        self._depth = np.broadcast_to(np.asarray(depth, np.float64),
                                      self.zb.shape)

    def set_initial_fsl(self, fsl):
        self._fsl = np.broadcast_to(np.asarray(fsl, np.float64),
                                    self.zb.shape)

    def set_initial_discharge(self, qx=None, qy=None):
        if qx is not None:
            self._qx = np.broadcast_to(np.asarray(qx, np.float64),
                                       self.zb.shape)
        if qy is not None:
            self._qy = np.broadcast_to(np.asarray(qy, np.float64),
                                       self.zb.shape)

    def apply_edge_treatment(self, width: int = 1):
        """Raise bed walls on closed edges (reference:
        CDomainCartesian.cpp:773-799).  'open' leaves the static edge ring
        as-is, which acts as a fixed-state ghost row.

        ``width`` is the scheme's static-ring width (1 for Godunov/
        inertial, 2 for MUSCL-Hancock).  The reference always raises a
        one-cell wall, which under its 2nd-order kernel leaves a WET,
        never-updated ring-1 cell exchanging real flux with the interior —
        a steady mass leak at closed boundaries
        (src/Schemes/CLSchemeMUSCLHancock.clc:568-573 static bounds vs.
        CDomainCartesian.cpp:773-799 single-ring wall).  Raising the wall
        to the full static-ring width makes closed domains conserve mass
        exactly for every scheme."""
        zb = self.zb
        lr, lc = self.logical_rows, self.logical_cols
        w = max(1, int(width))
        if self.edge_treatment.get("north") == "closed":
            zb[lr - w:lr, :lc] = C.CLOSED_EDGE_ELEVATION
        if self.edge_treatment.get("south") == "closed":
            zb[0:w, :lc] = C.CLOSED_EDGE_ELEVATION
        if self.edge_treatment.get("east") == "closed":
            zb[:lr, lc - w:lc] = C.CLOSED_EDGE_ELEVATION
        if self.edge_treatment.get("west") == "closed":
            zb[:lr, 0:w] = C.CLOSED_EDGE_ELEVATION

    def build(self, dtype=np.float64, apply_edges=True, edge_wall_width=1,
              datum_shift=False):
        """Materialise (FlowState, DomainStatic) device arrays.

        Initial conditions are evaluated against the ORIGINAL bed, and only
        then are closed-edge walls raised — matching the reference, where
        applyDomainModifications runs in prepareSimulation after the initial
        conditions load (src/Schemes/CSchemeGodunov.cpp:1057).  Wall cells
        therefore end up deeply dry regardless of any initial depth placed
        on them.

        ``datum_shift`` stores elevations relative to ``self.datum`` =
        floor(min enabled bed): the whole-domain generalisation of the
        reference's per-face vertical datum shift (reconstructInterface,
        src/Schemes/CLSchemeGodunov.clc:27-159).  At single precision the
        absolute datum otherwise dominates the arithmetic — ulp(1000 m) =
        6.1e-5 m and z*z pressure terms lose ~1% — so the f32/f32c modes
        shift; f64 runs unshifted and stays the bit-exact oracle.  The
        -9999 disabled and 9999.9 wall sentinels are never shifted.
        """
        import jax.numpy as jnp

        z0 = 0.0
        if datum_shift:
            enabled0 = self.active & (self._zb0 < 9999.0)
            if enabled0.any():
                # floor() keeps the shift exactly representable in both
                # precisions, so zb - z0 rounds once, identically on host
                # and device.
                z0 = float(np.floor(self._zb0[enabled0].min()))
        self.datum = z0

        zb_init = np.where(self.active, self._zb0 - z0, self._zb0)
        fsl = None if self._fsl is None else self._fsl - z0
        state = make_initial_state(
            jnp.asarray(zb_init, dtype=dtype),
            depth=self._depth, fsl=fsl,
            qx=self._qx, qy=self._qy,
            active=self.active, dtype=dtype)
        if apply_edges:
            self.apply_edge_treatment(width=edge_wall_width)
        zb_static = np.where(self.active & (self.zb < 9999.0),
                             self.zb - z0, self.zb)
        static = DomainStatic(zb=jnp.asarray(zb_static, dtype=dtype),
                              manning=jnp.asarray(self.manning, dtype=dtype))
        return state, static
