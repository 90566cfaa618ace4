"""qi2lab datastore: versioned on-disk MERFISH experiment store.

A from-scratch, contract-compatible implementation of the reference
``qi2labDataStore`` (reference `qi2labDataStore.py`, layout documented in
`docs/datastore.md:211-290`): Version 0.6 layout, OME-NGFF v0.5 zarr3 images
(via TensorStore, see :mod:`.zarrio`), per-entity ``attributes.json``
sidecars, parquet tables, and a ``datastore_state.json`` stage-flag state
machine. The datastore is the durable communication/checkpoint medium for
the whole pipeline: every stage is idempotent against its outputs and
workers re-open the store by path.

Tiles/rounds/bits are 0-indexed in the Python API and stored as 1-based
zero-padded IDs (``tile0000``, ``round001``, ``bit001``;
reference `qi2labDataStore.py:453-455,839-845`).
"""

from __future__ import annotations

import gzip
import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import pandas as pd

from . import zarrio

ArrayLike = Union[np.ndarray, Sequence]


class _DequantFuture:
    """Wraps a TensorStore read future so ``.result()`` dequantizes u8
    probability data to exact k/255 float32 (matching the non-future
    load path)."""

    def __init__(self, future):
        self._future = future

    def result(self):
        return qi2labDataStore._dequantize_prob(np.asarray(self._future.result()))


def _maybe_float(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


_STATE_KEYS = (
    "Version",
    "Initialized",
    "Calibrations",
    "Corrected",
    "LocalRegistered",
    "GlobalRegistered",
    "Fused",
    "SegmentedCells",
    "DecodedSpots",
    "FilteredSpots",
)


class qi2labDataStore:
    """Contract-compatible qi2lab datastore (Version 0.6)."""

    VERSION = 0.6

    def __init__(self, datastore_path: Union[str, Path], validate: bool = True):
        self._datastore_path = Path(datastore_path)
        self._decode_run_key: Optional[str] = None
        # bumped on every stored-transform mutation (round affines, flow
        # fields, chromatic affines) so same-process consumers holding
        # derived device state (the decoder's warped-stack memo) can
        # detect staleness without re-reading the sidecars
        self.transform_version: int = 0
        if (self._datastore_path / "datastore_state.json").exists():
            self._parse_datastore(validate=validate)
        else:
            self._init_datastore()

    # ------------------------------------------------------------------ paths
    @property
    def datastore_path(self) -> Path:
        return self._datastore_path

    @property
    def _calibrations_path(self) -> Path:
        return self._datastore_path / "calibrations"

    @property
    def _fiducial_path(self) -> Path:
        return self._datastore_path / "fiducial"

    @property
    def _readouts_path(self) -> Path:
        return self._datastore_path / "readouts"

    @property
    def _fp_localizations_path(self) -> Path:
        return self._datastore_path / "feature_predictor_localizations"

    @property
    def _fused_path(self) -> Path:
        return self._datastore_path / "fused"

    @property
    def _segmentation_path(self) -> Path:
        return self._datastore_path / "segmentation"

    @property
    def _decoded_path(self) -> Path:
        return self._datastore_path / "decoded"

    @property
    def _filtered_path(self) -> Path:
        return self._datastore_path / "all_tiles_filtered_decoded_features"

    # --------------------------------------------------------------- creation
    def _init_datastore(self) -> None:
        """Create the Version 0.6 skeleton (`qi2labDataStore.py:1308-1354`)."""
        for p in (
            self._datastore_path,
            self._calibrations_path,
            self._calibrations_path / "psf_data",
            self._fiducial_path,
            self._readouts_path,
            self._fp_localizations_path,
            self._fused_path,
            self._segmentation_path / "cellpose",
            self._decoded_path,
            self._filtered_path,
            self._datastore_path / "mtx_output",
        ):
            p.mkdir(parents=True, exist_ok=True)
        self._datastore_state = {k: False for k in _STATE_KEYS}
        self._datastore_state["Version"] = self.VERSION
        self._datastore_state["Initialized"] = True
        self._write_state()
        self._save_calibration_attrs({})

    def _write_state(self) -> None:
        # write-temp-then-rename: the state file is the durable
        # checkpoint gate every reopen parses BEFORE validation — a kill
        # mid-dump must never leave a truncated JSON (review r3)
        target = self._datastore_path / "datastore_state.json"
        tmp = target.with_suffix(".json.tmp")
        with tmp.open("w") as fh:
            json.dump(self._datastore_state, fh, indent=2)
        os.replace(tmp, target)

    @property
    def datastore_state(self) -> dict:
        return dict(self._datastore_state)

    @datastore_state.setter
    def datastore_state(self, value: Mapping[str, Any]) -> None:
        self._datastore_state.update(dict(value))
        self._write_state()

    # ------------------------------------------------------ attribute helpers
    def _attrs_path(self, entity_dir: Path) -> Path:
        return entity_dir / "attributes.json"

    def _load_attrs(self, entity_dir: Path) -> dict:
        p = self._attrs_path(entity_dir)
        if not p.exists():
            return {}
        with p.open("r", encoding="utf-8") as fh:
            return json.load(fh)

    def _save_attrs(self, entity_dir: Path, updates: Mapping[str, Any]) -> None:
        entity_dir.mkdir(parents=True, exist_ok=True)
        attrs = self._load_attrs(entity_dir)
        attrs.update(zarrio._json_safe(dict(updates)))
        target = self._attrs_path(entity_dir)
        tmp = target.with_suffix(".json.tmp")
        with tmp.open("w", encoding="utf-8") as fh:
            json.dump(attrs, fh, indent=2)
        os.replace(tmp, target)  # atomic: no truncated sidecars on kill

    def _load_entity_attributes(self, entity_dir: Path, image_name: str | None = None) -> dict:
        """Sidecar attrs merged with per-image extra attrs
        (`qi2labDataStore.py:1851-1895`)."""
        attrs = self._load_attrs(entity_dir)
        if image_name is not None:
            img = entity_dir / (image_name + ".ome.zarr")
            if (img / "zarr.json").exists():
                attrs.update(zarrio.read_image_attrs(img))
        return attrs

    def _save_calibration_attrs(self, updates: Mapping[str, Any]) -> None:
        self._save_attrs(self._calibrations_path, updates)

    def _set_calibration_attribute(self, key: str, value: Any) -> None:
        self._save_calibration_attrs({key: value})

    def _get_calibration_attribute(self, key: str, default: Any = None) -> Any:
        return self._load_attrs(self._calibrations_path).get(key, default)

    # ------------------------------------------------------------- state load
    def _parse_datastore(self, validate: bool = True) -> None:
        """Re-open an existing datastore (`qi2labDataStore.py:2423-2845`).

        Loads stage flags and calibration attributes into memory. With
        ``validate=True``, re-validates the whole store against the state
        flags like the reference: per-entity attribute-key checks, zarr
        metadata + chunk-presence checks, cross-array shape consistency,
        and decoded/filtered parquet presence. ``validate=False`` is the
        escape hatch for partially written stores."""
        with (self._datastore_path / "datastore_state.json").open("r") as fh:
            self._datastore_state = json.load(fh)
        version = self._datastore_state.get("Version")
        if version != self.VERSION:
            raise ValueError(
                f"Unsupported datastore version {version}; expected {self.VERSION}"
            )
        attrs = self._load_attrs(self._calibrations_path)
        for key in (
            "microscope_type",
            "camera_model",
            "num_rounds",
            "num_bits",
            "num_tiles",
            "channels_in_data",
            "tile_overlap",
            "binning",
            "e_per_ADU",
            "na",
            "ri",
            "voxel_size_zyx_um",
            "codebook",
            "exp_order",
            "psf_manifest",
            "global_normalization_vector",
            "global_background_vector",
            "iterative_normalization_vector",
            "iterative_background_vector",
            "chromatic_affine_transforms_zyx_um",
        ):
            if key in attrs:
                setattr(self, "_" + key, attrs[key])
        if getattr(self, "_exp_order", None) is not None:
            eo = np.asarray(self._exp_order)
            self._num_rounds = int(eo[-1, 0])
            self._num_bits = int(np.max(eo[:, 1:]))
        if validate:
            self._validate_against_state()

    # --------------------------------------------------- open-time validation
    def _validate_image(self, group_path: Path, what: str):
        """Validate an OME image without reading voxel data: group + array
        zarr.json must parse, and a non-empty array must have at least one
        chunk on disk (catches truncated/corrupted writes at open time
        instead of mid-stage; reference `_check_for_zarr_array` analog).
        Returns the array shape."""
        group_path = zarrio.image_store_path(group_path)
        if not (group_path / "zarr.json").exists():
            raise FileNotFoundError(f"{what}: missing image {group_path}")
        arr_meta_path = group_path / "0" / "zarr.json"
        try:
            with arr_meta_path.open("r", encoding="utf-8") as fh:
                meta = json.load(fh)
            shape = tuple(int(v) for v in meta["shape"])
        except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"{what}: corrupt zarr metadata at {arr_meta_path}: {e}"
            ) from e
        if int(np.prod(shape)) > 0:
            chunk_root = group_path / "0" / "c"
            # count chunk FILES — a truncated write can leave empty chunk
            # directories behind, which must still fail validation
            has_chunk = chunk_root.exists() and any(
                p.is_file() for p in chunk_root.rglob("*")
            )
            if not has_chunk:
                raise ValueError(
                    f"{what}: zarr array at {group_path} has shape {shape} "
                    "but no chunk data on disk (truncated write?)"
                )
        return shape

    def _require_attrs(
        self, entity_dir: Path, keys, what: str, image_name: str | None = None
    ) -> dict:
        attrs = self._load_entity_attributes(entity_dir, image_name)
        for key in keys:
            if key not in attrs:
                raise KeyError(f"{what}: attribute '{key}' missing in {entity_dir}")
        return attrs

    def _validate_against_state(self) -> None:
        """Per-state-flag revalidation (reference
        `_parse_datastore:2560-2845` semantics on the v0.6 zarr3 layout)."""
        state = self._datastore_state
        tile_ids = self.tile_ids
        round_ids = self.round_ids
        bit_ids = self.bit_ids

        if state.get("Corrected", False):
            if not any(self._fiducial_path.glob("tile*")):
                raise FileNotFoundError(
                    "Datastore marked Corrected but has no fiducial tiles."
                )
            for tid in tile_ids:
                for rid in round_ids:
                    d = self._fiducial_dir(tid, rid)
                    self._require_attrs(
                        d,
                        ("stage_zyx_um", "excitation_um", "emission_um",
                         "psf_idx", "bit_linker"),
                        f"Corrected fiducial {tid}/{rid}",
                        image_name="corrected_data",
                    )
                    self._validate_image(
                        d / "corrected_data", f"Corrected fiducial {tid}/{rid}"
                    )
                for bid in bit_ids:
                    d = self._readout_dir(tid, bid)
                    self._require_attrs(
                        d,
                        ("excitation_um", "emission_um", "psf_idx", "round_linker"),
                        f"Corrected readout {tid}/{bid}",
                        image_name="corrected_data",
                    )
                    self._validate_image(
                        d / "corrected_data", f"Corrected readout {tid}/{bid}"
                    )

        if state.get("LocalRegistered", False):
            for tid in tile_ids:
                for rid in round_ids:
                    d = self._fiducial_dir(tid, rid)
                    if rid != round_ids[0]:
                        self._require_attrs(
                            d,
                            ("local_round_transform_zyx_um",),
                            f"LocalRegistered fiducial {tid}/{rid}",
                        )
                    reg = d / "registered_decon_data.ome.zarr"
                    if rid == round_ids[0] or (reg / "zarr.json").exists():
                        reg_shape = self._validate_image(
                            reg, f"LocalRegistered fiducial {tid}/{rid}"
                        )
                        corr = d / "corrected_data.ome.zarr"
                        if (corr / "zarr.json").exists():
                            corr_shape = self._validate_image(
                                corr, f"Corrected fiducial {tid}/{rid}"
                            )
                            if corr_shape != reg_shape:
                                raise ValueError(
                                    f"{tid}/{rid}: corrected and registered "
                                    f"shapes differ: {corr_shape} != {reg_shape}"
                                )
                for bid in bit_ids:
                    d = self._readout_dir(tid, bid)
                    shapes = {}
                    for name in ("corrected_data", "decon_data",
                                 "feature_predictor_data"):
                        p = d / (name + ".ome.zarr")
                        if (p / "zarr.json").exists():
                            shapes[name] = self._validate_image(
                                p, f"LocalRegistered readout {tid}/{bid}/{name}"
                            )
                    if len(set(shapes.values())) > 1:
                        raise ValueError(
                            f"{tid}/{bid}: readout image shapes differ: {shapes}"
                        )
                    loc = self._fp_localizations_path / tid / (bid + ".parquet")
                    if not loc.exists():
                        raise FileNotFoundError(
                            f"{tid}/{bid}: feature predictor localizations missing"
                        )

        if state.get("GlobalRegistered", False) and round_ids:
            for tid in tile_ids:
                self._require_attrs(
                    self._fiducial_dir(tid, round_ids[0]),
                    ("affine_zyx_um", "origin_zyx_um", "spacing_zyx_um"),
                    f"GlobalRegistered {tid}",
                )

        if state.get("Fused", False):
            p = self._fused_path / "fused.zarr" / "fused_fiducial_zyx.ome.zarr"
            self._validate_image(p, "Fused fiducial image")
            attrs = zarrio.read_image_attrs(p)
            for key in ("affine_zyx_um", "origin_zyx_um", "spacing_zyx_um"):
                if key not in attrs:
                    raise KeyError(f"Fused image metadata missing '{key}'")

        if state.get("SegmentedCells", False):
            self._validate_image(
                self._segmentation_path / "cellpose" / "cellpose.zarr"
                / "masks_fiducial_iso_zyx",
                "Cellpose segmentation mask",
            )
            if not (
                self._segmentation_path / "cellpose" / "cell_outlines.json"
            ).exists():
                raise FileNotFoundError("Cellpose cell outlines missing.")

        # decode outputs may be namespaced under a decode_run_key
        # subdirectory; at open time the key is not yet known, so accept
        # the root layout OR any keyed run that wrote the file
        # (review r3: a keyed decode made the store unopenable)
        if state.get("DecodedSpots", False):
            for tid in tile_ids:
                name = tid + "_decoded_features.parquet"
                if not (self._decoded_path / name).exists() and not any(
                    self._decoded_path.glob(f"*/{name}")
                ):
                    raise FileNotFoundError(f"{tid}: decoded spots missing")

        if state.get("FilteredSpots", False):
            name = "decoded_features.parquet"
            if not (self._filtered_path / name).exists() and not any(
                self._filtered_path.glob(f"*/{name}")
            ):
                raise FileNotFoundError("filtered decoded spots missing")

    # ------------------------------------------------------------------- IDs
    @property
    def tile_ids(self) -> list[str]:
        n = self.num_tiles or 0
        return [f"tile{i:04d}" for i in range(n)]

    @property
    def round_ids(self) -> list[str]:
        n = self.num_rounds or 0
        return [f"round{i + 1:03d}" for i in range(n)]

    @property
    def bit_ids(self) -> list[str]:
        n = self.num_bits or 0
        return [f"bit{i + 1:03d}" for i in range(n)]

    def _tile_id(self, tile: Union[int, str]) -> str:
        if isinstance(tile, str):
            if not tile.startswith("tile"):
                raise ValueError(f"invalid tile id {tile!r}")
            return tile
        return f"tile{int(tile):04d}"

    def _round_id(self, round: Union[int, str]) -> str:
        if isinstance(round, str):
            if not round.startswith("round"):
                raise ValueError(f"invalid round id {round!r}")
            return round
        return f"round{int(round) + 1:03d}"

    def _bit_id(self, bit: Union[int, str]) -> str:
        if isinstance(bit, str):
            if not bit.startswith("bit"):
                raise ValueError(f"invalid bit id {bit!r}")
            return bit
        return f"bit{int(bit) + 1:03d}"

    def _fiducial_dir(self, tile, round) -> Path:
        return self._fiducial_path / self._tile_id(tile) / self._round_id(round)

    def _readout_dir(self, tile, bit) -> Path:
        return self._readouts_path / self._tile_id(tile) / self._bit_id(bit)

    # --------------------------------------------------- calibration scalars
    def _calibration_property(name, cast=None):  # type: ignore[misc]
        attr = "_" + name

        def getter(self):
            return getattr(self, attr, None)

        def setter(self, value):
            if cast is not None and value is not None:
                value = cast(value)
            setattr(self, attr, value)
            self._set_calibration_attribute(name, value)

        return property(getter, setter)

    microscope_type = _calibration_property("microscope_type", str)
    camera_model = _calibration_property("camera_model", str)
    num_tiles = _calibration_property("num_tiles", int)
    tile_overlap = _calibration_property("tile_overlap", float)
    binning = _calibration_property("binning", int)
    e_per_ADU = _calibration_property("e_per_ADU", float)
    na = _calibration_property("na", float)
    ri = _calibration_property("ri", float)

    del _calibration_property

    @property
    def num_rounds(self) -> Optional[int]:
        return getattr(self, "_num_rounds", None)

    @num_rounds.setter
    def num_rounds(self, value: int) -> None:
        self._num_rounds = int(value)
        self._set_calibration_attribute("num_rounds", self._num_rounds)

    @property
    def num_bits(self) -> Optional[int]:
        return getattr(self, "_num_bits", None)

    @num_bits.setter
    def num_bits(self, value: int) -> None:
        self._num_bits = int(value)
        self._set_calibration_attribute("num_bits", self._num_bits)

    @property
    def channels_in_data(self) -> Optional[list[str]]:
        return getattr(self, "_channels_in_data", None)

    @channels_in_data.setter
    def channels_in_data(self, value: Sequence[str]) -> None:
        self._channels_in_data = [str(v) for v in value]
        self._set_calibration_attribute("channels_in_data", self._channels_in_data)

    @property
    def voxel_size_zyx_um(self) -> Optional[np.ndarray]:
        v = getattr(self, "_voxel_size_zyx_um", None)
        return None if v is None else np.asarray(v, dtype=np.float64)

    @voxel_size_zyx_um.setter
    def voxel_size_zyx_um(self, value: ArrayLike) -> None:
        self._voxel_size_zyx_um = [float(v) for v in np.asarray(value).ravel()]
        self._set_calibration_attribute("voxel_size_zyx_um", self._voxel_size_zyx_um)

    # --------------------------------------------- experiment order, codebook
    @property
    def experiment_order(self) -> Optional[pd.DataFrame]:
        """Round↔bit table; first col = round id (1-based), rest = bit ids
        (`qi2labDataStore.py:767-845`, `docs/datastore.md`)."""
        eo = getattr(self, "_exp_order", None)
        if eo is None:
            return None
        eo = np.asarray(eo)
        cols = ["round"] + [f"readout {i}" for i in range(1, eo.shape[1])]
        if self.channels_in_data is not None and len(self.channels_in_data) == eo.shape[1]:
            cols = list(self.channels_in_data)
        return pd.DataFrame(eo, columns=cols).astype("int64")

    @experiment_order.setter
    def experiment_order(self, value: Union[ArrayLike, pd.DataFrame, str, Path]) -> None:
        if isinstance(value, (str, Path)):
            sep = "\t" if str(value).endswith(".tsv") else ","
            value = pd.read_csv(value, sep=sep)
        if isinstance(value, pd.DataFrame):
            value = value.values
        eo = np.asarray(value, dtype=np.int64)
        self._exp_order = eo.tolist()
        self._set_calibration_attribute("exp_order", self._exp_order)
        self._num_rounds = int(eo[-1, 0])
        self._set_calibration_attribute("num_rounds", self._num_rounds)
        self._num_bits = int(np.max(eo[:, 1:]))
        self._set_calibration_attribute("num_bits", self._num_bits)

    @property
    def codebook(self) -> Optional[pd.DataFrame]:
        data = getattr(self, "_codebook", None)
        if data is None:
            return None
        ncol = len(data[0]) if data else 0
        cols = ["gene_id"] + [f"bit{i:02d}" for i in range(1, ncol)]
        df = pd.DataFrame(data, columns=cols)
        for c in cols[1:]:
            df[c] = df[c].astype("int64")
        return df

    def load_codebook_parsed(self):
        """Codebook split into (gene_ids, bool on-bit matrix) — the viewer's
        gene→bit mapping input (reference `qi2labDataStore.py:2847-2875`)."""
        df = self.codebook
        if df is None:
            return None
        gene_ids = [str(g) for g in df["gene_id"]]
        matrix = df.iloc[:, 1:].to_numpy(dtype=np.int64)
        return gene_ids, matrix

    @codebook.setter
    def codebook(self, value: Union[pd.DataFrame, str, Path]) -> None:
        if isinstance(value, (str, Path)):
            sep = "\t" if str(value).endswith(".tsv") else ","
            value = pd.read_csv(value, sep=sep)
        self._codebook = [list(r) for r in value.values.tolist()]
        self._set_calibration_attribute("codebook", self._codebook)

    # --------------------------------------------------- calibration images
    @property
    def noise_map(self) -> Optional[np.ndarray]:
        p = self._calibrations_path / "noise_map.ome.zarr"
        if not (p / "zarr.json").exists():
            return None
        return zarrio.read_ome_image(p)

    @noise_map.setter
    def noise_map(self, value: Optional[ArrayLike]) -> None:
        if value is None:
            return
        zarrio.write_ome_image(self._calibrations_path / "noise_map", np.asarray(value))

    @property
    def channel_shading_maps(self) -> Optional[np.ndarray]:
        p = self._calibrations_path / "shading_maps.ome.zarr"
        if not (p / "zarr.json").exists():
            return None
        return zarrio.read_ome_image(p)

    @channel_shading_maps.setter
    def channel_shading_maps(self, value: Optional[ArrayLike]) -> None:
        if value is None:
            return
        zarrio.write_ome_image(
            self._calibrations_path / "shading_maps", np.asarray(value)
        )

    @property
    def channel_psfs(self) -> Optional[list[np.ndarray]]:
        """Per-channel (possibly ragged) PSF stack via ``psf_manifest``
        (`qi2labDataStore.py:695-766`)."""
        manifest = getattr(self, "_psf_manifest", None)
        if manifest is None:
            return None
        psfs = []
        for name in manifest:
            psfs.append(
                zarrio.read_ome_image(self._calibrations_path / "psf_data" / name)
            )
        return psfs

    @channel_psfs.setter
    def channel_psfs(self, value: Sequence[ArrayLike]) -> None:
        manifest = []
        for idx, psf in enumerate(value):
            name = f"psf_{idx:03d}"
            zarrio.write_ome_image(
                self._calibrations_path / "psf_data" / name,
                np.asarray(psf, dtype=np.float32),
            )
            manifest.append(name + ".ome.zarr")
        self._psf_manifest = manifest
        self._set_calibration_attribute("psf_manifest", manifest)

    # ------------------------------------------- normalization vector state
    def _vector_property(name):  # type: ignore[misc]
        attr = "_" + name

        def getter(self):
            v = getattr(self, attr, None)
            if v is None:
                v = self._get_calibration_attribute(name)
                if v is not None:
                    setattr(self, attr, v)
            return None if v is None else np.asarray(v, dtype=np.float32)

        def setter(self, value):
            value = [float(x) for x in np.asarray(value).ravel()]
            setattr(self, attr, value)
            self._set_calibration_attribute(name, value)

        return property(getter, setter)

    global_normalization_vector = _vector_property("global_normalization_vector")
    global_background_vector = _vector_property("global_background_vector")
    iterative_normalization_vector = _vector_property("iterative_normalization_vector")
    iterative_background_vector = _vector_property("iterative_background_vector")

    del _vector_property

    # run-scoped decode normalization (`qi2labDataStore.py:1167-1270`):
    # vectors are namespaced by the active decode_run_key AND the vector
    # kind ("global" percentile seed vs "iterative" refinement)
    def _norm_run_entry_key(self, kind: str, run_key: Optional[str]) -> str:
        namespace = run_key if run_key is not None else (self._decode_run_key or "default")
        return f"{namespace}/{kind}"

    def save_decode_normalization_vectors(
        self,
        normalization: ArrayLike,
        background: ArrayLike,
        run_key: Optional[str] = None,
        kind: Optional[str] = None,
    ) -> None:
        # back-compat: callers pass kind via run_key ("global"/"iterative")
        if kind is None and run_key in ("global", "iterative"):
            kind, run_key = run_key, None
        runs = self._get_calibration_attribute("decode_normalization_runs", {}) or {}
        runs[self._norm_run_entry_key(kind or "global", run_key)] = {
            "normalization": [float(v) for v in np.asarray(normalization).ravel()],
            "background": [float(v) for v in np.asarray(background).ravel()],
        }
        self._set_calibration_attribute("decode_normalization_runs", runs)

    def load_decode_normalization_vectors(
        self, run_key: Optional[str] = None, kind: Optional[str] = None
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        if kind is None and run_key in ("global", "iterative"):
            kind, run_key = run_key, None
        runs = self._get_calibration_attribute("decode_normalization_runs", {}) or {}
        entry = runs.get(self._norm_run_entry_key(kind or "global", run_key))
        if entry is None:
            return None
        return (
            np.asarray(entry["normalization"], dtype=np.float32),
            np.asarray(entry["background"], dtype=np.float32),
        )

    # --------------------------------------------------- chromatic affines
    def save_chromatic_affine_transforms_zyx_um(
        self, calibration: Mapping[str, Any], diagnostics: Optional[dict] = None
    ) -> None:
        """Per-channel 4x4 physical-space chromatic affines
        (`qi2labDataStore.py:175-275`). Structured payload:
        ``{"channels": {name: {"channel_index", "wavelength_um",
        "affine_zyx_um"}}}``. A flat ``{name: 4x4}`` mapping is also
        accepted and normalized to the structured form."""
        self.transform_version += 1
        calibration = dict(calibration)
        if "channels" not in calibration:
            calibration = {
                "channels": {
                    str(k): {
                        "channel_index": i,
                        "wavelength_um": _maybe_float(k),
                        "affine_zyx_um": np.asarray(v, dtype=np.float64)
                        .reshape(4, 4)
                        .tolist(),
                    }
                    for i, (k, v) in enumerate(calibration.items())
                }
            }
        self._chromatic_affine_transforms_zyx_um = zarrio._json_safe(calibration)
        self._set_calibration_attribute(
            "chromatic_affine_transforms_zyx_um",
            self._chromatic_affine_transforms_zyx_um,
        )
        if diagnostics is not None:
            self._set_calibration_attribute("chromatic_affine_diagnostics", diagnostics)

    def load_chromatic_affine_transforms_zyx_um(self) -> dict[str, Any]:
        """Returns the structured chromatic calibration payload (may be {})."""
        payload = getattr(self, "_chromatic_affine_transforms_zyx_um", None)
        if payload is None:
            payload = self._get_calibration_attribute(
                "chromatic_affine_transforms_zyx_um", {}
            ) or {}
        return dict(payload)

    def load_chromatic_affine_transform_zyx_um(
        self,
        channel_name: Optional[str] = None,
        channel_index: Optional[int] = None,
        wavelength_um: Optional[float] = None,
    ) -> np.ndarray:
        """One chromatic affine with identity fallback
        (`qi2labDataStore.py:220-275`)."""
        channels = self.load_chromatic_affine_transforms_zyx_um().get("channels", {})
        if not isinstance(channels, Mapping):
            return np.eye(4, dtype=np.float32)
        candidates = []
        if channel_name is not None and str(channel_name) in channels:
            candidates.append(channels[str(channel_name)])
        if channel_index is not None:
            for ch in channels.values():
                if isinstance(ch, Mapping) and int(ch.get("channel_index", -1)) == int(
                    channel_index
                ):
                    candidates.append(ch)
        if wavelength_um is not None:
            for ch in channels.values():
                if not isinstance(ch, Mapping):
                    continue
                stored = ch.get("wavelength_um")
                if stored is not None and np.isclose(
                    float(stored), float(wavelength_um)
                ):
                    candidates.append(ch)
        for ch in candidates:
            affine = ch.get("affine_zyx_um")
            if affine is not None:
                return np.asarray(affine, dtype=np.float32)
        return np.eye(4, dtype=np.float32)

    # ----------------------------------------------------------- tile setup
    def initialize_tile(self, tile: Union[int, str]) -> None:
        """Create per-tile fiducial round and readout bit directories and the
        round↔bit linker attributes derived from experiment_order
        (`qi2labDataStore.py:2877-2962`)."""
        if self.experiment_order is None:
            raise ValueError("experiment_order must be set before initialize_tile")
        eo = np.asarray(self._exp_order)
        tid = self._tile_id(tile)
        for r_idx in range(self.num_rounds):
            d = self._fiducial_path / tid / self.round_ids[r_idx]
            d.mkdir(parents=True, exist_ok=True)
            bits = [int(b) for b in eo[r_idx, 1:]]
            self._save_attrs(d, {"bit_linker": bits})
        for b_idx in range(self.num_bits):
            d = self._readouts_path / tid / self.bit_ids[b_idx]
            d.mkdir(parents=True, exist_ok=True)
            round_of_bit = int(eo[np.any(eo[:, 1:] == b_idx + 1, axis=1), 0][0])
            self._save_attrs(d, {"round_linker": round_of_bit})
        (self._fp_localizations_path / tid).mkdir(parents=True, exist_ok=True)

    def load_local_bit_linker(self, tile, round) -> Optional[list[int]]:
        attrs = self._load_attrs(self._fiducial_dir(tile, round))
        v = attrs.get("bit_linker")
        return None if v is None else [int(b) for b in v]

    def save_local_bit_linker(self, bit_linker: Sequence[int], tile, round) -> None:
        self._save_attrs(
            self._fiducial_dir(tile, round), {"bit_linker": [int(b) for b in bit_linker]}
        )

    def load_local_round_linker(self, tile, bit) -> Optional[int]:
        attrs = self._load_attrs(self._readout_dir(tile, bit))
        v = attrs.get("round_linker")
        return None if v is None else int(v)

    def save_local_round_linker(self, round_linker: int, tile, bit) -> None:
        self._save_attrs(self._readout_dir(tile, bit), {"round_linker": int(round_linker)})

    # ------------------------------------------------- stage pos, wavelengths
    def save_local_stage_position_zyx_um(
        self,
        stage_zyx_um: ArrayLike,
        tile,
        round=None,
        bit=None,
        affine_zyx_px: Optional[ArrayLike] = None,
    ) -> None:
        """Stage origin plus camera-to-stage 4x4 pixel affine
        (`qi2labDataStore.py:3292-3364`)."""
        d = self._entity_dir(tile, round, bit)
        if affine_zyx_px is None:
            affine_zyx_px = np.eye(4)
        self._save_attrs(
            d,
            {
                "stage_zyx_um": [float(v) for v in np.asarray(stage_zyx_um).ravel()],
                "affine_zyx_px": np.asarray(affine_zyx_px, dtype=np.float64)
                .reshape(4, 4)
                .tolist(),
            },
        )
        # reference also refreshes the OME translation transform on the
        # already-written corrected image (`qi2labDataStore.py:3358-3360`)
        zarrio.update_ome_translation(
            d / "corrected_data",
            [float(v) for v in np.asarray(stage_zyx_um).ravel()],
        )

    def load_local_stage_position_zyx_um(
        self, tile, round=None, bit=None
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        attrs = self._load_attrs(self._entity_dir(tile, round, bit))
        if "stage_zyx_um" not in attrs:
            return None
        stage = np.asarray(attrs["stage_zyx_um"], dtype=np.float64)
        affine = np.asarray(attrs.get("affine_zyx_px", np.eye(4)), dtype=np.float64)
        return stage, affine

    def save_local_wavelengths_um(
        self, wavelengths_um: Sequence[float], tile, round=None, bit=None
    ) -> None:
        d = self._entity_dir(tile, round, bit)
        ex, em = float(wavelengths_um[0]), float(wavelengths_um[1])
        self._save_attrs(d, {"excitation_um": ex, "emission_um": em})

    def load_local_wavelengths_um(
        self, tile, round=None, bit=None
    ) -> Optional[tuple[float, float]]:
        attrs = self._load_attrs(self._entity_dir(tile, round, bit))
        if "excitation_um" not in attrs:
            return None
        return float(attrs["excitation_um"]), float(attrs["emission_um"])

    def _entity_dir(self, tile, round=None, bit=None) -> Path:
        if (round is None) == (bit is None):
            raise ValueError("specify exactly one of round= or bit=")
        if round is not None:
            return self._fiducial_dir(tile, round)
        return self._readout_dir(tile, bit)

    # --------------------------------------------------------- image methods
    def _save_entity_image(
        self,
        array: np.ndarray,
        entity_dir: Path,
        name: str,
        *,
        dtype=None,
        extra_attributes: Optional[Mapping[str, Any]] = None,
        translation: Optional[Sequence[float]] = None,
        chunks: Optional[Sequence[int]] = None,
    ) -> None:
        scale = None
        if self.voxel_size_zyx_um is not None and array.ndim >= 3:
            scale = list(self.voxel_size_zyx_um)
        if translation is None and name == "corrected_data":
            # keep the OME translation in sync with the stored stage origin
            # (reference `qi2labDataStore.py:3358-3360`)
            stage = self._load_attrs(entity_dir).get("stage_zyx_um")
            if stage is not None:
                translation = [float(v) for v in stage]
        zarrio.write_ome_image(
            entity_dir / name,
            array,
            dtype=dtype,
            scale=scale,
            translation=translation,
            extra_attributes=extra_attributes,
            chunks=chunks,
        )

    def _load_entity_image(
        self, entity_dir: Path, name: str, return_future: bool = False
    ):
        p = entity_dir / (name + ".ome.zarr")
        if not (p / "zarr.json").exists():
            return None
        return zarrio.read_ome_image(p, return_future=return_future)

    def local_image_shape(
        self, tile, round=None, bit=None, *, image: str = "registered"
    ) -> Optional[tuple[int, ...]]:
        """Shape of a stored entity image from zarr metadata only (no chunk
        reads) — resume validation checks shape consistency without paying
        for a full decode (reference `_validate_core_image_shape:2100-2144`,
        `_has_valid_registered_image:1285`)."""
        if image == "corrected":
            d, name = self._entity_dir(tile, round, bit), "corrected_data"
        elif image == "registered":
            d = self._entity_dir(tile, round, bit)
            name = "registered_decon_data" if round is not None else "decon_data"
        elif image == "feature_predictor":
            d, name = self._readout_dir(tile, bit), "feature_predictor_data"
        else:
            raise ValueError(f"unknown image kind {image!r}")
        p = d / (name + ".ome.zarr")
        if not (p / "zarr.json").exists():
            return None
        try:
            return tuple(int(s) for s in zarrio.open_ome_array(p).shape)
        except Exception:
            return None  # unreadable/corrupt metadata → treated as missing

    def remove_local_registered_image(self, tile, round=None, bit=None) -> None:
        """Delete a stored registered/decon image if present. Used by
        minimal-persistence registration (`DataRegistration(persist=
        'minimal')`) so a stale decon array from an earlier run can never
        shadow the intentionally-skipped write (the decoder's zarr
        fallback would silently read it)."""
        import shutil

        d = self._entity_dir(tile, round, bit)
        name = "registered_decon_data" if round is not None else "decon_data"
        p = d / (name + ".ome.zarr")
        if p.exists():
            shutil.rmtree(p, ignore_errors=True)

    def save_local_corrected_image(
        self,
        image: ArrayLike,
        tile,
        round=None,
        bit=None,
        psf_idx: int = 0,
        gain_correction: bool = False,
        hotpixel_correction: bool = False,
        shading_correction: bool = False,
    ) -> None:
        """uint16 camera-corrected stack with correction flags + psf index
        (`qi2labDataStore.py:3656-3789`)."""
        d = self._entity_dir(tile, round, bit)
        self._save_entity_image(
            np.asarray(image),
            d,
            "corrected_data",
            dtype=np.uint16,
            extra_attributes={
                "psf_idx": int(psf_idx),
                "gain_correction": bool(gain_correction),
                "hotpixel_correction": bool(hotpixel_correction),
                "shading_correction": bool(shading_correction),
            },
        )

    def load_local_corrected_image(
        self, tile, round=None, bit=None, return_future: bool = False
    ):
        return self._load_entity_image(
            self._entity_dir(tile, round, bit), "corrected_data", return_future
        )

    def load_local_corrected_image_attrs(self, tile, round=None, bit=None) -> dict:
        """Correction-provenance attrs of a corrected stack (psf_idx +
        gain/hotpixel/shading flags), so re-save passes (e.g. flatfield
        application) can preserve what they don't change."""
        return self._load_entity_attributes(
            self._entity_dir(tile, round, bit), "corrected_data"
        )

    def save_local_rigid_xform_xyz_px(self, rigid_xform_xyz_px: ArrayLike, tile, round) -> None:
        self._save_attrs(
            self._fiducial_dir(tile, round),
            {"rigid_xform_xyz_px": [float(v) for v in np.asarray(rigid_xform_xyz_px).ravel()]},
        )

    def load_local_rigid_xform_xyz_px(self, tile, round) -> Optional[np.ndarray]:
        attrs = self._load_attrs(self._fiducial_dir(tile, round))
        v = attrs.get("rigid_xform_xyz_px")
        return None if v is None else np.asarray(v, dtype=np.float32)

    def save_local_round_transform_zyx_um(self, transform_zyx_um: ArrayLike, tile, round) -> None:
        """4x4 physical affine mapping round-1 reference coords → moving round
        coords (`qi2labDataStore.py:3983-4052`)."""
        self.transform_version += 1
        self._save_attrs(
            self._fiducial_dir(tile, round),
            {
                "local_round_transform_zyx_um": np.asarray(transform_zyx_um, dtype=np.float64)
                .reshape(4, 4)
                .tolist()
            },
        )

    def load_local_round_transform_zyx_um(self, tile, round) -> Optional[np.ndarray]:
        attrs = self._load_attrs(self._fiducial_dir(tile, round))
        v = attrs.get("local_round_transform_zyx_um")
        return None if v is None else np.asarray(v, dtype=np.float32)

    # ------------------------------------------- legacy warpfield optical flow
    def save_coord_of_xform_px(
        self,
        flow_field: ArrayLike,
        tile,
        round,
        *,
        block_size: ArrayLike,
        block_stride: ArrayLike,
    ) -> None:
        """Legacy warpfield dense optical-flow field
        (`qi2labDataStore.py:4136-4224`): stored only as the OME-Zarr array
        with identity OME transforms plus block_size/block_stride attrs."""
        d = self._fiducial_dir(tile, round)
        arr = np.asarray(flow_field, dtype=np.float32)
        zarrio.write_ome_image(
            d / "opticalflow_xform_px",
            arr,
            extra_attributes={
                "block_size": [float(v) for v in np.asarray(block_size).ravel()],
                "block_stride": [float(v) for v in np.asarray(block_stride).ravel()],
            },
        )

    def load_coord_of_xform_px(
        self, tile, round
    ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        d = self._fiducial_dir(tile, round)
        p = d / "opticalflow_xform_px.ome.zarr"
        if not (p / "zarr.json").exists():
            return None
        arr = zarrio.read_ome_image(p).astype(np.float32)
        attrs = zarrio.read_image_attrs(p)
        return (
            arr,
            np.asarray(attrs["block_size"], dtype=np.float32),
            np.asarray(attrs["block_stride"], dtype=np.float32),
        )

    # ------------------------------------------------------ sofima flow field
    def save_local_sofima_flow_field(
        self,
        flow_field: ArrayLike,
        tile,
        round,
        *,
        map_stride_zyx_px: Sequence[float],
        map_box_start_xyz_px: Sequence[float],
        map_box_size_xyz_px: Sequence[float],
        reference_shape_zyx_px: Sequence[int],
        moving_shape_zyx_px: Optional[Sequence[int]] = None,
        sofima_status: str = "ok",
        valid_flow_vectors: int = 0,
        extra: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """float32 ``(3, z, y, x)`` flow map, channels X,Y,Z, values in
        reference px; metadata per `docs/datastore.md:46-51` and
        `qi2labDataStore.py:4307-4463`. Round-trip must be exact (float32)."""
        self.transform_version += 1
        d = self._fiducial_dir(tile, round)
        attrs = {
            "map_stride_zyx_px": [float(v) for v in map_stride_zyx_px],
            "map_box_start_xyz_px": [float(v) for v in map_box_start_xyz_px],
            "map_box_size_xyz_px": [float(v) for v in map_box_size_xyz_px],
            "reference_shape_zyx_px": [int(v) for v in reference_shape_zyx_px],
            "sofima_status": str(sofima_status),
            "valid_flow_vectors": int(valid_flow_vectors),
        }
        if moving_shape_zyx_px is not None:
            attrs["moving_shape_zyx_px"] = [int(v) for v in moving_shape_zyx_px]
        if extra:
            attrs.update(dict(extra))
        arr = np.asarray(flow_field, dtype=np.float32)
        zarrio.write_ome_image(
            d / "local_sofima_flow_field",
            arr,
            extra_attributes=attrs,
            chunks=[1, *arr.shape[1:]] if arr.ndim == 4 else None,
        )

    def load_local_sofima_flow_field(
        self, tile, round
    ) -> Optional[tuple[np.ndarray, dict]]:
        d = self._fiducial_dir(tile, round)
        p = d / "local_sofima_flow_field.ome.zarr"
        if not (p / "zarr.json").exists():
            return None
        arr = zarrio.read_ome_image(p).astype(np.float32)
        attrs = zarrio.read_image_attrs(p)
        return arr, attrs

    # --------------------------------------------------- registered / decon
    def save_local_registered_image(
        self,
        image: ArrayLike,
        tile,
        round=None,
        bit=None,
        deconvolution: bool = True,
        extra_attributes: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """Fiducial rounds → ``registered_decon_data``; readout bits →
        **unwarped** ``decon_data`` (decode applies transforms lazily;
        `qi2labDataStore.py:4578-4700`)."""
        d = self._entity_dir(tile, round, bit)
        name = "registered_decon_data" if round is not None else "decon_data"
        attrs = {"deconvolution": bool(deconvolution)}
        if extra_attributes:
            attrs.update(dict(extra_attributes))
        self._save_entity_image(
            np.asarray(image), d, name, dtype=np.uint16, extra_attributes=attrs
        )

    def load_local_registered_image(
        self, tile, round=None, bit=None, return_future: bool = False
    ):
        d = self._entity_dir(tile, round, bit)
        name = "registered_decon_data" if round is not None else "decon_data"
        return self._load_entity_image(d, name, return_future)

    def save_local_feature_predictor_image(
        self,
        image: ArrayLike,
        tile,
        bit,
        model_name: str = "",
        extra_attributes: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """U-FISH probability map, same shape as corrected
        (`qi2labDataStore.py:4781-4870`).

        Stored as uint8 with a 1/255 scale (attr ``quantization``):
        probabilities live in [0, 1], the pipeline quantizes predictor
        output to k/255 at the source (pipeline/registration.py) so every
        consumer — device cache, disk, host and device paths — sees the SAME
        k/255 values, and the u8 volume is a quarter of f32's bytes on
        the device→host link and the single-core compressor, the two
        measured bottlenecks of the per-tile critical path. Loads
        dequantize to float32 (exactly k/255). Float inputs that are not
        already k/255 quantize here (round-half-even, matching the device
        path's jnp.round)."""
        d = self._readout_dir(tile, bit)
        attrs = {"model_name": str(model_name), "quantization": "u8/255"}
        if extra_attributes:
            attrs.update(dict(extra_attributes))
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(
                np.round(arr.astype(np.float32) * 255.0), 0.0, 255.0
            ).astype(np.uint8)
        self._save_entity_image(
            arr,
            d,
            "feature_predictor_data",
            extra_attributes=attrs,
        )

    def load_local_feature_predictor_image(
        self, tile, bit, return_future: bool = False, raw: bool = False
    ):
        """``raw=True`` returns the stored u8 quantized volume without
        dequantizing — consumers that re-upload to the device (the decode
        cache-population path) want the k/255 integers, not 4× the bytes
        of f32."""
        out = self._load_entity_image(
            self._readout_dir(tile, bit), "feature_predictor_data", return_future
        )
        if raw:
            return out
        if out is None or return_future:
            # futures dequantize at .result() via _DequantFuture
            return (
                _DequantFuture(out) if (return_future and out is not None) else out
            )
        return self._dequantize_prob(np.asarray(out))

    @staticmethod
    def _dequantize_prob(arr: np.ndarray) -> np.ndarray:
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / np.float32(255.0)
        return np.asarray(arr, np.float32)

    def save_local_feature_predictor_spots(
        self, spots: pd.DataFrame, tile, bit
    ) -> None:
        d = self._fp_localizations_path / self._tile_id(tile)
        d.mkdir(parents=True, exist_ok=True)
        spots.to_parquet(d / (self._bit_id(bit) + ".parquet"), engine="pyarrow")

    def load_local_feature_predictor_spots(self, tile, bit) -> Optional[pd.DataFrame]:
        p = self._fp_localizations_path / self._tile_id(tile) / (
            self._bit_id(bit) + ".parquet"
        )
        if not p.exists():
            return None
        return pd.read_parquet(p, engine="pyarrow")

    # --------------------------------------------------------------- global
    def save_global_coord_xforms_um(
        self,
        tile,
        *,
        affine_zyx_um: ArrayLike,
        origin_zyx_um: ArrayLike,
        spacing_zyx_um: ArrayLike,
    ) -> None:
        """Per-tile global (affine, origin, spacing) stored on round-1
        fiducial attrs (`qi2labDataStore.py:5056-5115`)."""
        d = self._fiducial_dir(tile, 0)
        self._save_attrs(
            d,
            {
                "affine_zyx_um": np.asarray(affine_zyx_um, dtype=np.float64)
                .reshape(4, 4)
                .tolist(),
                "origin_zyx_um": [float(v) for v in np.asarray(origin_zyx_um).ravel()],
                "spacing_zyx_um": [float(v) for v in np.asarray(spacing_zyx_um).ravel()],
            },
        )

    def load_global_coord_xforms_um(
        self, tile
    ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        attrs = self._load_attrs(self._fiducial_dir(tile, 0))
        if "affine_zyx_um" not in attrs:
            return None
        return (
            np.asarray(attrs["affine_zyx_um"], dtype=np.float64),
            np.asarray(attrs["origin_zyx_um"], dtype=np.float64),
            np.asarray(attrs["spacing_zyx_um"], dtype=np.float64),
        )

    def save_global_fiducial_image(
        self,
        image: ArrayLike,
        *,
        affine_zyx_um: ArrayLike,
        origin_zyx_um: ArrayLike,
        spacing_zyx_um: ArrayLike,
        all_channels: bool = False,
    ) -> None:
        name = "fused_all_channels_zyx" if all_channels else "fused_fiducial_zyx"
        arr = np.asarray(image)
        zarrio.write_ome_image(
            self._fused_path / "fused.zarr" / name,
            arr,
            chunks=zarrio.fused_chunks(arr.shape),
            extra_attributes={
                "affine_zyx_um": np.asarray(affine_zyx_um, dtype=np.float64)
                .reshape(4, 4)
                .tolist(),
                "origin_zyx_um": [float(v) for v in np.asarray(origin_zyx_um).ravel()],
                "spacing_zyx_um": [float(v) for v in np.asarray(spacing_zyx_um).ravel()],
            },
        )

    def create_global_fused_image(
        self,
        shape: Sequence[int],
        dtype,
        *,
        affine_zyx_um: ArrayLike,
        origin_zyx_um: ArrayLike,
        spacing_zyx_um: ArrayLike,
        all_channels: bool = False,
    ):
        """Create an empty fused OME-Zarr and return the writable
        TensorStore handle for chunk-by-chunk streaming fusion (reference
        fuses straight to `output_zarr_url`, `DataRegistration.py:1728-1743`)."""
        name = "fused_all_channels_zyx" if all_channels else "fused_fiducial_zyx"
        return zarrio.create_ome_image(
            self._fused_path / "fused.zarr" / name,
            [int(s) for s in shape],
            dtype,
            chunks=zarrio.fused_chunks(shape),
            extra_attributes={
                "affine_zyx_um": np.asarray(affine_zyx_um, dtype=np.float64)
                .reshape(4, 4)
                .tolist(),
                "origin_zyx_um": [float(v) for v in np.asarray(origin_zyx_um).ravel()],
                "spacing_zyx_um": [
                    float(v) for v in np.asarray(spacing_zyx_um).ravel()
                ],
            },
        )

    def load_global_fiducial_image(
        self, return_future: bool = False, all_channels: bool = False
    ):
        name = "fused_all_channels_zyx" if all_channels else "fused_fiducial_zyx"
        p = self._fused_path / "fused.zarr" / (name + ".ome.zarr")
        if not (p / "zarr.json").exists():
            return None
        img = zarrio.read_ome_image(p, return_future=return_future)
        attrs = zarrio.read_image_attrs(p)
        return img, (
            np.asarray(attrs["affine_zyx_um"], dtype=np.float64),
            np.asarray(attrs["origin_zyx_um"], dtype=np.float64),
            np.asarray(attrs["spacing_zyx_um"], dtype=np.float64),
        )

    def load_global_fused_geometry(self):
        """(affine, origin, spacing) of the fused fiducial image without
        reading the voxel data (attrs-only; for mask/coordinate mapping)."""
        p = self._fused_path / "fused.zarr" / "fused_fiducial_zyx.ome.zarr"
        if not (p / "zarr.json").exists():
            return None
        attrs = zarrio.read_image_attrs(p)
        return (
            np.asarray(attrs["affine_zyx_um"], dtype=np.float64),
            np.asarray(attrs["origin_zyx_um"], dtype=np.float64),
            np.asarray(attrs["spacing_zyx_um"], dtype=np.float64),
        )

    # --------------------------------------------------------- segmentation
    def save_global_cellpose_segmentation_image(
        self,
        image: ArrayLike,
        *,
        downsampling: Sequence[float] = (1.0, 1.0, 1.0),
    ) -> None:
        arr = np.asarray(image)
        zarrio.write_ome_image(
            self._segmentation_path / "cellpose" / "cellpose.zarr" / "masks_fiducial_iso_zyx",
            arr,
            chunks=zarrio.fused_chunks(arr.shape),
            extra_attributes={"downsampling": [float(v) for v in downsampling]},
        )

    def load_global_cellpose_segmentation_image(self, return_future: bool = False):
        p = (
            self._segmentation_path
            / "cellpose"
            / "cellpose.zarr"
            / "masks_fiducial_iso_zyx.ome.zarr"
        )
        if not (p / "zarr.json").exists():
            return None
        return zarrio.read_ome_image(p, return_future=return_future)

    def load_global_cellpose_segmentation_downsampling(self) -> Optional[np.ndarray]:
        """The per-axis downsampling of the stored mask relative to the
        fused fiducial image (attrs-only)."""
        p = (
            self._segmentation_path
            / "cellpose"
            / "cellpose.zarr"
            / "masks_fiducial_iso_zyx.ome.zarr"
        )
        if not (p / "zarr.json").exists():
            return None
        attrs = zarrio.read_image_attrs(p)
        return np.asarray(attrs.get("downsampling", [1.0, 1.0, 1.0]), np.float64)

    def save_global_cellpose_outlines(self, outlines: dict) -> None:
        d = self._segmentation_path / "cellpose"
        d.mkdir(parents=True, exist_ok=True)
        with (d / "cell_outlines.json").open("w", encoding="utf-8") as fh:
            json.dump(zarrio._json_safe(outlines), fh)

    def load_global_cellpose_outlines(self) -> Optional[dict]:
        p = self._segmentation_path / "cellpose" / "cell_outlines.json"
        if not p.exists():
            return None
        with p.open("r", encoding="utf-8") as fh:
            return json.load(fh)

    # ------------------------------------------------------- decoded tables
    @property
    def decode_run_key(self) -> Optional[str]:
        return self._decode_run_key

    @decode_run_key.setter
    def decode_run_key(self, value: Optional[str]) -> None:
        if value is not None and not re.match(r"^[A-Za-z0-9_\-]+$", value):
            raise ValueError(f"invalid decode_run_key {value!r}")
        self._decode_run_key = value

    def _decoded_run_root(self) -> Path:
        if self._decode_run_key:
            return self._decoded_path / self._decode_run_key
        return self._decoded_path

    def decoded_temporary_dir(self, iteration: int) -> Path:
        d = self._decoded_run_root() / "temporary" / f"iteration_{iteration:03d}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def clear_decoded_temporary(self) -> None:
        d = self._decoded_run_root() / "temporary"
        if d.exists():
            shutil.rmtree(d)

    def save_local_decoded_spots(self, features: pd.DataFrame, tile) -> None:
        d = self._decoded_run_root()
        d.mkdir(parents=True, exist_ok=True)
        features.to_parquet(
            d / (self._tile_id(tile) + "_decoded_features.parquet"), engine="pyarrow"
        )

    def load_local_decoded_spots(self, tile) -> Optional[pd.DataFrame]:
        p = self._decoded_run_root() / (self._tile_id(tile) + "_decoded_features.parquet")
        if not p.exists():
            return None
        return pd.read_parquet(p, engine="pyarrow")

    def save_global_filtered_decoded_spots(self, features: pd.DataFrame) -> None:
        """Final filtered table: parquet + gzipped CSV (the Proseg contract;
        `qi2labDataStore.py:5339-5371`, `README.md:92-99`)."""
        d = self._filtered_path
        if self._decode_run_key:
            d = d / self._decode_run_key
        d.mkdir(parents=True, exist_ok=True)
        features.to_parquet(d / "decoded_features.parquet", engine="pyarrow")
        with gzip.open(d / "decoded_features.csv.gz", "wt") as fh:
            features.to_csv(fh, index=False)

    def load_global_filtered_decoded_spots(self) -> Optional[pd.DataFrame]:
        d = self._filtered_path
        if self._decode_run_key:
            d = d / self._decode_run_key
        p = d / "decoded_features.parquet"
        if not p.exists():
            return None
        return pd.read_parquet(p, engine="pyarrow")
