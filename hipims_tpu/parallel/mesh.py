"""Device-mesh construction and array sharding helpers.

The domain grid is sharded over a 2-D ("my", "mx") mesh: rows over "my",
columns over "mx".  The reference only ever splits domains row-wise
(src/Domain/Links/CDomainLink.cpp:297-336 assumes matching columns); here
the decomposition is genuinely two-dimensional so halo bytes scale with the
perimeter, not the width.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import DomainStatic, FlowState


def _factor_2d(n: int) -> Tuple[int, int]:
    """Most-square factorisation of n (rows x cols)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ('my', 'mx') mesh over the given/available devices."""
    if devices is None:
        devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if shape is None:
        shape = _factor_2d(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    import numpy as np
    dev_grid = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_grid, ("my", "mx"))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (rows, cols) domain arrays."""
    return NamedSharding(mesh, P("my", "mx"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_simulation_arrays(mesh: Mesh, state: FlowState,
                            static: DomainStatic):
    """Place state/static grids on the mesh, sharded 2-D.

    Grid dimensions need not divide the mesh evenly — XLA pads
    internally.
    """
    gs = grid_sharding(mesh)
    state = FlowState(*(jax.device_put(a, gs) for a in state))
    static = DomainStatic(*(jax.device_put(a, gs) for a in static))
    return state, static
