"""The port's parquet recordings (`ssqueeze_rs_tpu_torch.io`) against the
JAX package's (`ssqueeze_rs_tpu.io`) on a seeded parquet file of several
row groups, on the CPU. Both read the same file through pyarrow and
gather the halos by the same reflect rule, so every read is bitwise
equal, as is the raw file `parquet_to_raw` writes; the raw file is
bitwise the array and feeds the port's native reader.
"""
import numpy as np
import pytest

pytest.importorskip("pyarrow")

from ssqueeze_rs_tpu import io as J
from ssqueeze_rs_tpu_torch import io as T
from ssqueeze_rs_tpu_torch import native
from ssqueeze_rs_tpu_torch.utils.pad import _reflect_indices


@pytest.fixture(scope="module")
def parquet_file(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(3)
    data = rng.standard_normal((3, 5000)).astype(np.float32)
    cols = {f"ch{c}": data[c] for c in range(3)}
    cols["label"] = np.array(["a"] * 5000)       # not a channel
    path = tmp_path_factory.mktemp("pq") / "rec.parquet"
    pq.write_table(pa.table(cols), path, row_group_size=700)
    return str(path), data


def test_have_pyarrow():
    assert T.have_pyarrow() == J.have_pyarrow() is True
    assert T._reflect_indices is _reflect_indices


@pytest.mark.parametrize("columns", [None, ["ch2", "ch0"]])
@pytest.mark.parametrize("start, cl, hl, hr", [
    (0, 1000, 64, 64), (650, 700, 128, 128), (4500, 500, 256, 256),
    (0, 5000, 300, 300), (100, 50, 0, 0), (4999, 1, 12_000, 7)])
def test_read_chunk_bitwise(parquet_file, columns, start, cl, hl, hr):
    path, data = parquet_file
    with T.ParquetRecording(path, columns=columns) as rec:
        ref = J.ParquetRecording(path, columns=columns)
        assert rec.columns == ref.columns
        assert (rec.n_channels, rec.n_samples) == (ref.n_channels,
                                                   ref.n_samples)
        got = rec.read_chunk(start, cl, hl, hr)
        assert np.array_equal(got, ref.read_chunk(start, cl, hl, hr))
        rows = [0, 1, 2] if columns is None else [2, 0]
        idx = _reflect_indices(start - hl, start + cl + hr, 5000)
        assert np.array_equal(got, data[rows][:, idx])
        ref.close()


def test_iter_chunks_and_to_numpy(parquet_file):
    path, data = parquet_file
    rec, ref = T.ParquetRecording(path), J.ParquetRecording(path)
    assert np.array_equal(rec.to_numpy(), ref.to_numpy())
    assert np.array_equal(rec.to_numpy(), data)
    ours, theirs = (list(r.iter_chunks(1800, 90)) for r in (rec, ref))
    assert [s for s, _ in ours] == [s for s, _ in theirs] == [0, 1800, 3600]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(ours, theirs))
    rec.close()
    ref.close()


def test_parquet_to_raw(parquet_file, tmp_path):
    path, data = parquet_file
    out, C, N = T.parquet_to_raw(path, tmp_path / "t.f32", chunk_len=1024)
    J.parquet_to_raw(path, tmp_path / "j.f32", chunk_len=1024)
    assert (C, N) == (3, 5000) and out == tmp_path / "t.f32"
    raw = (tmp_path / "t.f32").read_bytes()
    assert raw == (tmp_path / "j.f32").read_bytes()
    assert np.array_equal(np.frombuffer(raw, np.float32).reshape(C, N), data)
    with native.MappedRecording(out, n_channels=C) as rec:
        chunks = list(rec.iter_chunks_prefetch(1500, 64))
    with T.ParquetRecording(path) as pqr:
        want = list(pqr.iter_chunks(1500, 64))
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(chunks, want))


def test_refusals(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    p = tmp_path / "text.parquet"
    pq.write_table(pa.table({"s": ["x", "y"]}), p)
    for mod in (T, J):
        with pytest.raises(ValueError, match="no numeric columns"):
            mod.ParquetRecording(p)
    with pytest.raises(FileNotFoundError):
        T.ParquetRecording(tmp_path / "missing.parquet")
