"""Parquet recordings (counterpart of ``ssqueeze_rs_tpu/io.py``).

A `ParquetRecording` has the read interface of `native.MappedRecording`
(halo-overlapped reflect chunk reads), so `parallel.process_recording`
takes either source; `parquet_to_raw` converts a parquet file to the
channel-major float32 raw layout the native reader and its prefetch ring
map. Only the row groups a read overlaps are read. pyarrow is imported
inside these functions, so the package imports without it.
"""
from __future__ import annotations

import numpy as np

from .utils.pad import _reflect_indices

__all__ = ["ParquetRecording", "parquet_to_raw", "have_pyarrow"]


def have_pyarrow() -> bool:
    try:
        import pyarrow.parquet  # noqa: F401
        return True
    except ImportError:
        return False


class ParquetRecording:
    """Multichannel recording stored as a parquet file with one column
    per channel. Same read interface as `native.MappedRecording`.

    `columns`: channel column names (default: all numeric columns, file
    order). `memory_map=True` maps the file instead of reading it.
    """

    def __init__(self, path, columns=None, memory_map=True,
                 dtype="float32"):
        import pyarrow.parquet as pq

        self._pf = pq.ParquetFile(path, memory_map=memory_map)
        schema = self._pf.schema_arrow
        if columns is None:
            import pyarrow.types as pt
            columns = [f.name for f in schema
                       if pt.is_floating(f.type) or pt.is_integer(f.type)]
            if not columns:
                raise ValueError(f"no numeric columns in {path}")
        self.columns = list(columns)
        self.n_channels = len(self.columns)
        self.n_samples = int(self._pf.metadata.num_rows)
        self.dtype = np.dtype(dtype)
        md = self._pf.metadata
        rows = [md.row_group(i).num_rows for i in range(md.num_row_groups)]
        self._rg_bounds = np.concatenate([[0], np.cumsum(rows)])

    def _read_range(self, a: int, b: int) -> np.ndarray:
        """(n_channels, b - a) for the clipped absolute range [a, b)."""
        a, b = max(0, int(a)), min(self.n_samples, int(b))
        if b <= a:
            return np.empty((self.n_channels, 0), self.dtype)
        g0 = int(np.searchsorted(self._rg_bounds, a, side="right") - 1)
        g1 = int(np.searchsorted(self._rg_bounds, b, side="left"))
        tbl = self._pf.read_row_groups(list(range(g0, g1)),
                                       columns=self.columns)
        off = a - int(self._rg_bounds[g0])
        out = np.empty((self.n_channels, b - a), self.dtype)
        for c, name in enumerate(self.columns):
            col = tbl.column(name).to_numpy(zero_copy_only=False)
            out[c] = col[off:off + (b - a)].astype(self.dtype, copy=False)
        return out

    def read_chunk(self, start: int, chunk_len: int, halo_left: int = 0,
                   halo_right: int = 0) -> np.ndarray:
        """(n_channels, halo_left + chunk_len + halo_right), reflect
        boundary at the recording edges."""
        N = self.n_samples
        lo, hi = start - halo_left, start + chunk_len + halo_right
        if lo >= 0 and hi <= N:
            return self._read_range(lo, hi)
        idx = _reflect_indices(lo, hi, N)
        a = int(idx.min())
        data = self._read_range(a, int(idx.max()) + 1)
        return data[:, idx - a]

    def iter_chunks(self, chunk_len: int, halo: int):
        """Yield (start, chunk_with_halos) across the recording."""
        start = 0
        while start < self.n_samples:
            cl = min(chunk_len, self.n_samples - start)
            yield start, self.read_chunk(start, cl, halo, halo)
            start += chunk_len

    def to_numpy(self) -> np.ndarray:
        """(n_channels, n_samples): the whole recording (small files)."""
        return self._read_range(0, self.n_samples)

    def close(self):
        pf, self._pf = getattr(self, "_pf", None), None
        if pf is not None:
            pf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def parquet_to_raw(path, out_path, columns=None, chunk_len: int = 1 << 20):
    """Convert a parquet recording to the channel-major float32 raw
    layout of `native.MappedRecording`, chunk by chunk (constant memory):
    channel c holds bytes [c * n_samples, (c + 1) * n_samples) * 4.
    Returns (out_path, n_channels, n_samples).
    """
    with ParquetRecording(path, columns=columns) as rec:
        C, N = rec.n_channels, rec.n_samples
        out = np.memmap(out_path, dtype=np.float32, mode="w+", shape=(C, N))
        for start in range(0, N, chunk_len):
            cl = min(chunk_len, N - start)
            out[:, start:start + cl] = rec.read_chunk(start, cl)
        out.flush()
        del out
    return out_path, C, N
