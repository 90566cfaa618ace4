"""zarr v3 image I/O (numpy + zlib) against TensorStore, an independent
zarr v3 implementation: each side reads what the other wrote."""

import json

import numpy as np
import pytest

from merfish3d_tpu.datastore import zarrio


def _ts_open(path, **kw):
    ts = pytest.importorskip("tensorstore")
    return ts.open(
        {"driver": "zarr3", "kvstore": {"driver": "file", "path": str(path)}, **kw}
    ).result()


DTYPES = [np.uint16, np.uint8, np.int32, np.float32, np.float16, np.float64, bool]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_written_array_reads_in_tensorstore(tmp_path, dtype):
    a = (np.random.default_rng(0).random((5, 70, 33)) * 100).astype(dtype)
    zarrio.write_ome_image(tmp_path / "img", a, chunks=[2, 32, 16])
    got = _ts_open(tmp_path / "img.ome.zarr" / "0").read().result()
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(zarrio.read_ome_image(tmp_path / "img"), a)


@pytest.mark.parametrize(
    "shape,chunks",
    [((3, 40, 50), [1, 16, 16]), ((40, 50), [16, 50]), ((2, 3, 8, 9), [1, 1, 8, 4])],
)
def test_tensorstore_written_array_reads_here(tmp_path, shape, chunks):
    a = (np.random.default_rng(1).random(shape) * 1000).astype(np.uint16)
    store = _ts_open(
        tmp_path / "0",
        metadata={
            "shape": list(shape),
            "data_type": "uint16",
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": chunks}},
            "codecs": [
                {"name": "bytes", "configuration": {"endian": "little"}},
                {"name": "gzip", "configuration": {"level": 3}},
            ],
            "fill_value": 0,
        },
        create=True,
    )
    store[...] = a
    np.testing.assert_array_equal(zarrio.ZarrArray(tmp_path / "0")[...], a)


@pytest.mark.parametrize(
    "key",
    [
        (slice(1, 7), slice(3, 50), slice(10, 64)),
        (slice(0, 8), slice(0, 32), slice(0, 32)),
        (3, slice(None), 5),
        (Ellipsis, slice(60, 64)),
    ],
)
def test_partial_writes_and_reads(tmp_path, key):
    """Unaligned writes keep the rest of each chunk; TensorStore agrees."""
    rng = np.random.default_rng(2)
    arr = zarrio.create_ome_image(tmp_path / "img", (10, 64, 64), np.uint16,
                                  chunks=[4, 32, 32])
    ref = rng.integers(0, 1000, (10, 64, 64)).astype(np.uint16)
    arr[...] = ref
    v = rng.integers(0, 1000, ref[key].shape).astype(np.uint16)
    arr[key] = v
    ref[key] = v
    np.testing.assert_array_equal(arr[key], ref[key])
    np.testing.assert_array_equal(arr.read().result(), ref)
    np.testing.assert_array_equal(
        _ts_open(tmp_path / "img.ome.zarr" / "0").read().result(), ref
    )


def test_unwritten_chunks_read_as_fill(tmp_path):
    arr = zarrio.create_ome_image(tmp_path / "img", (4, 20, 20), np.float32,
                                  chunks=[1, 20, 20])
    arr[1] = np.ones((20, 20), np.float32)
    out = arr[...]
    assert out[1].sum() == 400 and out[[0, 2, 3]].sum() == 0


def test_recreate_starts_empty(tmp_path):
    zarrio.write_ome_image(tmp_path / "img", np.full((2, 8, 8), 7, np.uint16),
                           chunks=[1, 8, 8])
    arr = zarrio.create_ome_image(tmp_path / "img", (2, 8, 8), np.uint16)
    assert arr[...].sum() == 0


def test_metadata_is_zarr_v3_with_z_plane_chunks(tmp_path):
    zarrio.write_ome_image(tmp_path / "img", np.zeros((6, 40, 30), np.uint16),
                           scale=(0.3, 0.1, 0.1))
    meta = json.loads((tmp_path / "img.ome.zarr" / "0" / "zarr.json").read_text())
    assert meta["zarr_format"] == 3 and meta["node_type"] == "array"
    assert meta["chunk_grid"]["configuration"]["chunk_shape"] == [1, 40, 30]
    assert [c["name"] for c in meta["codecs"]] == ["bytes", "gzip"]
    group = json.loads((tmp_path / "img.ome.zarr" / "zarr.json").read_text())
    assert group["attributes"]["ome"]["version"] == "0.5"
    assert zarrio.read_ome_transforms(tmp_path / "img")[0] == [0.3, 0.1, 0.1]


def test_bad_selections_raise(tmp_path):
    arr = zarrio.create_ome_image(tmp_path / "img", (4, 8, 8), np.uint16)
    with pytest.raises(IndexError):
        arr[0:4:2]
    with pytest.raises(IndexError):
        arr[9]
    with pytest.raises(IndexError):
        arr[0, 0, 0, 0]
