"""OME-NGFF v0.5 zarr v3 image I/O with numpy and the standard library.

Implements the image-store contract of the qi2lab datastore (reference:
`qi2labDataStore.py:1431-1536, 1708-1789, 2239-2370` and `docs/datastore.md`):
each image is a standalone OME-NGFF v0.5 group directory ``<name>.ome.zarr/``
holding a group-level ``zarr.json`` (with the ``ome`` multiscales block plus
flat extra attributes) and a single-scale zarr v3 array at ``0/``.

The array is written with the ``bytes`` (little endian) and ``gzip``
codecs and the default ``c/i/j/k`` chunk keys, which every zarr v3 reader
(zarr-python, TensorStore) opens; compression runs in stdlib ``zlib``,
which releases the GIL, so chunks encode and decode on a thread pool.
Reads return futures (:meth:`ZarrArray.read`), so the pipeline can
overlap decompression with device compute as the reference does with
TensorStore futures. Only local paths are supported.
"""

from __future__ import annotations

import functools
import json
import os
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

_SPACE_AXES = ("z", "y", "x")
# gzip level 1: imaging data compresses within a few per cent of higher
# levels at several times the speed, and image writes sit on the
# pipeline's critical path
_GZIP_LEVEL = 1


def _json_safe(value: Any) -> Any:
    """Convert numpy scalars/arrays and paths to JSON-encodable types."""
    if isinstance(value, np.ndarray):
        return [_json_safe(v) for v in value.tolist()]
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    return value


@functools.cache
def _chunk_pool() -> ThreadPoolExecutor:
    """Workers that encode/decode chunks (zlib releases the GIL)."""
    return ThreadPoolExecutor(
        max_workers=min(16, os.cpu_count() or 1),
        thread_name_prefix="zarr-chunk",
    )


@functools.cache
def _read_pool() -> ThreadPoolExecutor:
    """Workers behind :meth:`ZarrArray.read` futures: whole-array reads,
    each decoding its chunks in turn, so many arrays read at once."""
    return ThreadPoolExecutor(
        max_workers=min(16, os.cpu_count() or 1),
        thread_name_prefix="zarr-read",
    )


def _selection(key, shape: tuple[int, ...]):
    """Basic-indexing key → (starts, stops, axes kept in the result)."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1 :]
    key = key + (slice(None),) * (len(shape) - len(key))
    if len(key) != len(shape):
        raise IndexError(f"too many indices for a {len(shape)}-d array")
    starts, stops, kept = [], [], []
    for ax, (k, n) in enumerate(zip(key, shape)):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step != 1:
                raise IndexError("zarr selections take unit steps only")
            starts.append(start)
            stops.append(max(start, stop))
            kept.append(ax)
        else:
            i = int(k)
            i = i + n if i < 0 else i
            if not 0 <= i < n:
                raise IndexError(f"index {k} out of range for axis {ax} of size {n}")
            starts.append(i)
            stops.append(i + 1)
    return starts, stops, kept


class ZarrArray:
    """A zarr v3 array on local disk (regular chunk grid, ``bytes`` +
    optional ``gzip`` codecs), read and written with numpy."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        meta = json.loads((self.path / "zarr.json").read_text())
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            raise ValueError(f"{self.path} is not a zarr v3 array")
        self.shape = tuple(int(v) for v in meta["shape"])
        self.chunks = tuple(
            int(v) for v in meta["chunk_grid"]["configuration"]["chunk_shape"]
        )
        self._gzip_level = None
        endian = "little"
        for codec in meta["codecs"]:
            name = codec["name"]
            if name == "bytes":
                endian = codec.get("configuration", {}).get("endian", "little")
            elif name == "gzip":
                self._gzip_level = int(codec.get("configuration", {}).get("level", 5))
            else:
                raise ValueError(f"{self.path}: unsupported zarr codec {name!r}")
        dtype = np.dtype(meta["data_type"])
        self.dtype = dtype.newbyteorder("<" if endian == "little" else ">")
        self.fill_value = meta.get("fill_value", 0)
        enc = meta.get("chunk_key_encoding", {"name": "default"})
        self._separator = enc.get("configuration", {}).get(
            "separator", "/" if enc["name"] == "default" else "."
        )
        self._prefix = "c" if enc["name"] == "default" else None

    # ------------------------------------------------------------ chunks
    def _chunk_file(self, index) -> Path:
        parts = [str(int(i)) for i in index]
        if self._prefix is not None:
            parts = [self._prefix] + parts
        return self.path / self._separator.join(parts)

    def _read_chunk(self, index) -> np.ndarray:
        f = self._chunk_file(index)
        try:
            raw = f.read_bytes()
        except FileNotFoundError:
            return np.full(self.chunks, self.fill_value, self.dtype)
        if self._gzip_level is not None:
            raw = zlib.decompress(raw, wbits=47)  # gzip or zlib header
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)

    def _write_chunk(self, index, data: np.ndarray) -> None:
        raw = np.ascontiguousarray(data, self.dtype).tobytes()
        if self._gzip_level is not None:
            raw = zlib.compress(raw, self._gzip_level, wbits=31)  # gzip
        f = self._chunk_file(index)
        f.parent.mkdir(parents=True, exist_ok=True)
        tmp = f.with_name(f.name + f".{os.getpid()}.tmp")
        tmp.write_bytes(raw)
        os.replace(tmp, f)

    def _chunk_ranges(self, starts, stops):
        lo = [s // c for s, c in zip(starts, self.chunks)]
        hi = [-(-e // c) for e, c in zip(stops, self.chunks)]
        return np.ndindex(*[h - l for l, h in zip(lo, hi)]), lo

    # ------------------------------------------------------------ access
    def __getitem__(self, key) -> np.ndarray:
        starts, stops, kept = _selection(key, self.shape)
        out = np.empty([e - s for s, e in zip(starts, stops)], self.dtype)
        if out.size:
            grid, lo = self._chunk_ranges(starts, stops)

            def read_one(rel):
                idx = [l + r for l, r in zip(lo, rel)]
                c0 = [i * c for i, c in zip(idx, self.chunks)]
                a = [max(s, o) for s, o in zip(starts, c0)]
                b = [min(e, o + c) for e, o, c in zip(stops, c0, self.chunks)]
                chunk = self._read_chunk(idx)
                out[tuple(slice(x - s, y - s) for x, y, s in zip(a, b, starts))] = (
                    chunk[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, c0))]
                )

            for f in [_chunk_pool().submit(read_one, rel) for rel in grid]:
                f.result()
        return out.reshape([out.shape[ax] for ax in kept]).astype(
            self.dtype.newbyteorder("="), copy=False
        )

    def __setitem__(self, key, value) -> None:
        starts, stops, kept = _selection(key, self.shape)
        sel_shape = [e - s for s, e in zip(starts, stops)]
        value = np.broadcast_to(
            np.asarray(value).astype(self.dtype, copy=False),
            [sel_shape[ax] for ax in kept],
        ).reshape(sel_shape)
        if not value.size:
            return
        grid, lo = self._chunk_ranges(starts, stops)

        def write_one(rel):
            idx = [l + r for l, r in zip(lo, rel)]
            c0 = [i * c for i, c in zip(idx, self.chunks)]
            a = [max(s, o) for s, o in zip(starts, c0)]
            b = [min(e, o + c) for e, o, c in zip(stops, c0, self.chunks)]
            src = value[tuple(slice(x - s, y - s) for x, y, s in zip(a, b, starts))]
            full = all(
                x == o and y == min(o + c, n)
                for x, y, o, c, n in zip(a, b, c0, self.chunks, self.shape)
            )
            # edge chunks are stored at full chunk size (zarr v3); a chunk
            # written in part keeps what it already held
            chunk = (
                np.full(self.chunks, self.fill_value, self.dtype)
                if full
                else self._read_chunk(idx).copy()
            )
            chunk[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, c0))] = src
            self._write_chunk(idx, chunk)

        for f in [_chunk_pool().submit(write_one, rel) for rel in grid]:
            f.result()

    def read(self) -> Future:
        """Future of the whole array as a numpy array."""
        return _read_pool().submit(self.__getitem__, ...)


def _array_metadata(
    shape: Sequence[int], dtype: np.dtype, chunks: Sequence[int]
) -> dict:
    """zarr v3 array metadata: regular grid, default ``c/`` chunk keys,
    ``bytes`` + ``gzip`` codecs (reference
    `qi2labDataStore._create_array_tensorstore_qi2lab:1431-1536` uses blosc,
    which the standard library lacks)."""
    return {
        "zarr_format": 3,
        "node_type": "array",
        "shape": [int(s) for s in shape],
        "data_type": np.dtype(dtype).name,
        "chunk_grid": {
            "name": "regular",
            "configuration": {"chunk_shape": [int(c) for c in chunks]},
        },
        "chunk_key_encoding": {"name": "default", "configuration": {"separator": "/"}},
        "fill_value": np.zeros((), dtype).item(),
        "codecs": [
            {"name": "bytes", "configuration": {"endian": "little"}},
            {"name": "gzip", "configuration": {"level": _GZIP_LEVEL}},
        ],
        "attributes": {},
    }


def image_store_path(path: Path | str) -> Path:
    """Normalize a logical image name to its ``.ome.zarr`` directory."""
    p = Path(path)
    if p.name.endswith(".ome.zarr"):
        return p
    if p.suffixes:
        raise ValueError(
            f"Invalid image store name '{p.name}'; use bare names or '.ome.zarr'."
        )
    return p.with_name(p.name + ".ome.zarr")


def default_chunks(shape: Sequence[int]) -> list[int]:
    """Default chunk layout: z-plane chunks ``[1, Y, X]`` for 3D stacks
    (lateral chunks capped at 2048).

    Matches the reference access pattern (per-z-plane decode loops;
    `qi2labDataStore.py:1570-1591`). Leading non-spatial axes get chunk 1.
    """
    shape = list(int(s) for s in shape)
    if len(shape) == 2:
        return [min(shape[0], 2048), min(shape[1], 2048)]
    chunks = [1] * (len(shape) - 2)
    chunks += [min(shape[-2], 2048), min(shape[-1], 2048)]
    return chunks


def fused_chunks(shape: Sequence[int]) -> list[int]:
    """Chunk layout for large fused volumes (`qi2labDataStore.py:1594-1629`)."""
    shape = list(int(s) for s in shape)
    chunks = [1] * max(0, len(shape) - 3)
    tail = shape[-3:]
    if len(tail) == 3:
        chunks += [min(tail[0], 16), min(tail[1], 512), min(tail[2], 512)]
    else:
        chunks += [min(s, 512) for s in tail]
    return chunks


def _ome_axes(ndim: int, units: str = "micrometer") -> list[dict]:
    axes: list[dict] = []
    if ndim > 3:
        for i in range(ndim - 3):
            axes.append({"name": "c" if i == ndim - 4 else f"d{i}", "type": "channel"})
    for name in _SPACE_AXES[-min(ndim, 3):]:
        axes.append({"name": name, "type": "space", "unit": units})
    return axes


def create_ome_image(
    path: Path | str,
    shape: Sequence[int],
    dtype: np.dtype | str,
    *,
    scale: Sequence[float] | None = None,
    translation: Sequence[float] | None = None,
    extra_attributes: Mapping[str, Any] | None = None,
    chunks: Sequence[int] | None = None,
) -> ZarrArray:
    """Create an empty OME-NGFF v0.5 image group and return the writable
    level-0 array.

    This is the streaming write path: callers fill the array chunk by chunk
    (e.g. chunked direct-to-zarr fusion, reference
    `DataRegistration._fuse_global_registered_msims:1728-1743` where
    multiview-stitcher's ``fusion.fuse(output_zarr_url=...)`` writes each
    fused chunk straight to disk), so host memory stays bounded by one chunk
    rather than the full global volume.

    ``scale``/``translation`` follow the reference convention: only written
    when available, ordered like the array axes (zyx for 3D).
    Extra attributes are written flat into the group ``zarr.json`` attributes
    beside the ``ome`` key (reference `_write_extra_attributes`).
    """
    root = image_store_path(path)
    root.mkdir(parents=True, exist_ok=True)
    shape = [int(s) for s in shape]
    dtype = np.dtype(dtype)
    if chunks is None:
        chunks = default_chunks(shape)

    # group-level zarr.json with OME multiscales
    transforms: list[dict] = []
    ndim = len(shape)
    if scale is not None:
        s = [1.0] * (ndim - len(list(scale))) + [float(v) for v in scale]
        transforms.append({"type": "scale", "scale": s})
    else:
        transforms.append({"type": "scale", "scale": [1.0] * ndim})
    if translation is not None:
        t = [0.0] * (ndim - len(list(translation))) + [float(v) for v in translation]
        transforms.append({"type": "translation", "translation": t})

    attributes: dict[str, Any] = {
        "ome": {
            "version": "0.5",
            "multiscales": [
                {
                    "axes": _ome_axes(ndim),
                    "datasets": [
                        {"path": "0", "coordinateTransformations": transforms}
                    ],
                }
            ],
        }
    }
    if extra_attributes:
        attributes.update(_json_safe(dict(extra_attributes)))

    group_meta = {"zarr_format": 3, "node_type": "group", "attributes": attributes}
    with (root / "zarr.json").open("w", encoding="utf-8") as fh:
        json.dump(group_meta, fh, indent=2)

    array_dir = root / "0"
    if array_dir.exists():  # a re-created image starts empty
        import shutil

        shutil.rmtree(array_dir)
    array_dir.mkdir(parents=True)
    with (array_dir / "zarr.json").open("w", encoding="utf-8") as fh:
        json.dump(_array_metadata(shape, dtype, chunks), fh, indent=2)
    return ZarrArray(array_dir)


def write_ome_image(
    path: Path | str,
    array: np.ndarray,
    *,
    scale: Sequence[float] | None = None,
    translation: Sequence[float] | None = None,
    extra_attributes: Mapping[str, Any] | None = None,
    chunks: Sequence[int] | None = None,
    dtype: np.dtype | str | None = None,
) -> Path:
    """Write an array as a standalone OME-NGFF v0.5 image group."""
    array = np.asarray(array)
    if dtype is not None:
        array = array.astype(dtype)
    store = create_ome_image(
        path,
        array.shape,
        array.dtype,
        scale=scale,
        translation=translation,
        extra_attributes=extra_attributes,
        chunks=chunks,
    )
    store[...] = array
    return image_store_path(path)


def open_ome_array(path: Path | str) -> ZarrArray:
    """Open the level-0 array of an OME image (lazy handle)."""
    return ZarrArray(image_store_path(path) / "0")


def read_ome_image(path: Path | str, return_future: bool = False):
    """Read the level-0 array; optionally return the read future.

    Mirrors the reference's future-returning reads
    (`qi2labDataStore._load_from_zarr_array:2239-2269`) so callers can
    overlap decompression with device compute.
    """
    arr = open_ome_array(path)
    future = arr.read()
    if return_future:
        return future
    return future.result()


def read_image_attrs(path: Path | str) -> dict[str, Any]:
    """Read flat extra attributes from the group zarr.json (``ome`` removed)."""
    root = image_store_path(path)
    meta_path = root / "zarr.json"
    if not meta_path.exists():
        return {}
    with meta_path.open("r", encoding="utf-8") as fh:
        meta = json.load(fh)
    attrs = dict(meta.get("attributes", {}))
    attrs.pop("ome", None)
    return attrs


def write_image_attrs(
    path: Path | str, extra_attributes: Mapping[str, Any], merge: bool = True
) -> None:
    """Merge (or replace) flat extra attributes in the group zarr.json."""
    root = image_store_path(path)
    meta_path = root / "zarr.json"
    payload = _json_safe(dict(extra_attributes))
    if meta_path.exists():
        with meta_path.open("r", encoding="utf-8") as fh:
            meta = json.load(fh)
    else:
        meta = {"zarr_format": 3, "node_type": "group", "attributes": {}}
    attrs = meta.get("attributes", {})
    if not isinstance(attrs, dict):
        attrs = {}
    if merge:
        attrs.update(payload)
    else:
        ome = attrs.get("ome")
        attrs = dict(payload)
        if ome is not None:
            attrs["ome"] = ome
    meta["attributes"] = attrs
    with meta_path.open("w", encoding="utf-8") as fh:
        json.dump(meta, fh, indent=2)


def update_ome_translation(path: Path | str, translation: Sequence[float]) -> bool:
    """Rewrite the OME multiscales translation transform in place (used to
    keep the stored stage origin and the OME metadata in sync, reference
    `qi2labDataStore.py:3358-3360`). Returns False when no image exists."""
    root = image_store_path(path)
    meta_path = root / "zarr.json"
    if not meta_path.exists():
        return False
    with meta_path.open("r", encoding="utf-8") as fh:
        meta = json.load(fh)
    multiscales = meta.get("attributes", {}).get("ome", {}).get("multiscales")
    if not multiscales:
        return False
    for ms in multiscales:
        ndim = len(ms.get("axes", [])) or len(list(translation))
        t = [0.0] * (ndim - len(list(translation))) + [
            float(v) for v in translation
        ]
        for dataset in ms.get("datasets", []):
            transforms = dataset.setdefault("coordinateTransformations", [])
            for tr in transforms:
                if tr.get("type") == "translation":
                    tr["translation"] = t
                    break
            else:
                transforms.append({"type": "translation", "translation": t})
    with meta_path.open("w", encoding="utf-8") as fh:
        json.dump(meta, fh, indent=2)
    return True


def read_ome_transforms(path: Path | str) -> tuple[list[float], list[float]]:
    """Return (scale, translation) from the OME multiscales block."""
    root = image_store_path(path)
    with (root / "zarr.json").open("r", encoding="utf-8") as fh:
        meta = json.load(fh)
    ms = meta.get("attributes", {}).get("ome", {}).get("multiscales", [{}])[0]
    scale: list[float] = []
    translation: list[float] = []
    for tr in ms.get("datasets", [{}])[0].get("coordinateTransformations", []):
        if tr.get("type") == "scale":
            scale = [float(v) for v in tr["scale"]]
        elif tr.get("type") == "translation":
            translation = [float(v) for v in tr["translation"]]
    return scale, translation
