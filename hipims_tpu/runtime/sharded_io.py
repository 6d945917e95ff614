"""Bounded-memory output/checkpoint I/O for large (possibly multi-host)
grids.

The reference writes each domain's raster independently from its own
device (src/Domain/Cartesian/CDomainCartesian.cpp:804-829) and never
gathers the global grid anywhere.  This rebuild's small-grid path
gathers the whole grid on every process per output event
(runtime/simulation._OutputSnapshot) — fine at test scale, fatal at the
10^8-cell north star (~1.6 GB of host traffic per field per host per
event; SURVEY "Hard parts").  This module is the large-grid path:

* ``stream_global_rows`` — iterate a sharded global array as bounded
  row-chunks.  Each chunk is ONE jitted dynamic-slice + allgather, run
  symmetrically on every process (it is a collective), so peak host
  memory per process is one chunk, never the grid.
* ``StreamingCheckpointWriter`` — np.savez_compressed-compatible .npz
  written incrementally: whole planes stream chunk-by-chunk into one
  deflated zip member each (numpy's own reader loads the result).
* The raster writers in runtime/output.py consume the same chunks
  north-first and feed io.raster.TiffStripWriter / the ASC row writer,
  so raster bytes are identical between the streamed and gathered paths.

Only ranks with ``write_outputs`` touch the filesystem; every rank runs
the chunk collectives (the SPMD-symmetry rule of _OutputSnapshot).
"""

from __future__ import annotations

import struct
import zipfile
import zlib
from functools import partial

import numpy as np


_cut = None


def _replicated_slice(arr, r0, n_rows):
    """One bounded chunk of a (possibly multi-host sharded) global array,
    materialised on every process.  Collective: call symmetrically."""
    import jax

    if jax.process_count() == 1:
        # Single process: basic indexing devices->host copies only the
        # requested rows of each shard.
        return np.asarray(arr[r0:r0 + n_rows])

    global _cut
    if _cut is None:
        # Module-level jit so the trace/compile caches across chunks and
        # events (a per-call wrapper would recompile every chunk).
        @partial(jax.jit, static_argnums=(2,))
        def _cut_impl(a, r0_, n):
            return jax.lax.dynamic_slice_in_dim(a, r0_, n, axis=0)
        _cut = _cut_impl

    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        _cut(arr, r0, n_rows), tiled=True))


def stream_global_rows(arr, chunk_rows, reverse=False):
    """Yield ``(row0, host_chunk)`` covering rows [0, R) of the global
    array in chunks of at most ``chunk_rows`` (descending row order with
    ``reverse=True`` — rasters write north-first while domain arrays are
    south-up).  Chunk boundaries are identical in both directions, so
    forward and reverse streams see bit-identical blocks."""
    rows = arr.shape[0]
    starts = list(range(0, rows, chunk_rows))
    if reverse:
        starts = starts[::-1]
    for r0 in starts:
        n = min(chunk_rows, rows - r0)
        yield r0, _replicated_slice(arr, r0, n)


def chunk_rows_for(cols, n_fields=1, budget_mb=64):
    """Rows per chunk so one chunk set (all fields) stays under
    ``budget_mb`` of host memory, 8-row aligned."""
    bytes_per_row = max(1, cols * 4 * max(1, n_fields))
    rows = max(8, (budget_mb << 20) // bytes_per_row)
    return (rows // 8) * 8


class StreamingCheckpointWriter:
    """Writes a numpy-loadable .npz incrementally.

    Each ``add_array``/``stream_array`` emits one deflated ``<key>.npy``
    member; plane data arrives chunk-by-chunk so no full plane is ever
    assembled in host memory.  np.load reads the result exactly like a
    np.savez_compressed file (same container, same member format).
    """

    def __init__(self, path):
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED)

    def add_array(self, key, value):
        arr = np.asarray(value)
        with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, arr, allow_pickle=False)

    def stream_array(self, key, shape, dtype, chunks):
        """One large array from an iterable of row chunks (ascending)."""
        dtype = np.dtype(dtype)
        with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array_header_2_0(
                f, dict(descr=np.lib.format.dtype_to_descr(dtype),
                        fortran_order=False, shape=tuple(shape)))
            written = 0
            for chunk in chunks:
                chunk = np.ascontiguousarray(np.asarray(chunk, dtype))
                f.write(chunk.tobytes())
                written += chunk.shape[0]
            if written != shape[0]:
                # A short member would crash np.load at resume; fail the
                # save loudly instead (never an assert: python -O).
                raise ValueError(f"{key}: streamed {written} of "
                                 f"{shape[0]} rows")

    def close(self):
        self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AscStripWriter:
    """Incremental ESRI ASCII grid writer (top-down rows), mirroring
    io.raster._write_asc's format row-for-row."""

    def __init__(self, path, width, height, xll=0.0, yll=0.0,
                 cell_size=1.0, nodata=-9999.0):
        self.width, self.height = int(width), int(height)
        self._rows_in = 0
        self._f = open(path, "wb")
        self._f.write((f"ncols {width}\n"
                       f"nrows {height}\n"
                       f"xllcorner {xll}\n"
                       f"yllcorner {yll}\n"
                       f"cellsize {cell_size}\n"
                       f"NODATA_value {nodata}\n").encode())

    def write_rows(self, block):
        from ..native import asc_format_native
        block = np.asarray(block, np.float64)
        if block.ndim == 1:
            block = block[None, :]
        self._rows_in += block.shape[0]
        body = asc_format_native(block)
        if body is not None:
            self._f.write(body)
        else:
            np.savetxt(self._f, block, fmt="%.6f")

    def close(self):
        if self._rows_in != self.height:
            raise ValueError(f"wrote {self._rows_in} of {self.height} "
                             "rows; refusing to emit a truncated grid")
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
