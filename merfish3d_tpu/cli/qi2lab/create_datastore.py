"""qi2lab-datastore: raw acquisition → qi2lab datastore.

Mirrors `cli/qi2lab_microscopes/create_datastore.py:1-763` (raw →
datastore incl. camera gain/offset correction, hot-pixel correction and
theoretical PSF generation). Two raw layouts are supported:

- ``qi2lab``: the qi2lab microscope NDTiff layout (``scan_metadata.csv`` +
  ``{root_name}_rNNNN_tileNNNN_1`` NDTiff directories) — read through the
  self-contained NDTiff reader (`utils/ndtiff.py`; ndstorage/tifffile are
  not in this environment).
- ``generic``: ``metadata.json`` + per-tile npy/tif stacks (see
  sim-convert).

``--layout auto`` (default) picks qi2lab when ``scan_metadata.csv``
exists.
"""

from __future__ import annotations

import argparse
import json
from itertools import compress
from pathlib import Path

import numpy as np


def create_datastore(
    raw_dir: Path,
    output_dir: Path,
    *,
    hotpixel_correction: bool = True,
    hot_pixel_threshold: float = 375.0,
    psf_model: str = "gaussian",
):
    from ...datastore import qi2labDataStore
    from ...models.psf import make_channel_psfs
    from ...ops.filters import replace_hot_pixels
    from ...utils.dataio import load_stack

    raw_dir = Path(raw_dir)
    meta = json.loads((raw_dir / "metadata.json").read_text())
    ds = qi2labDataStore(Path(output_dir) / "qi2labdatastore")
    ds.channels_in_data = meta.get(
        "channels_in_data", ["fiducial", "readout1", "readout2"]
    )
    ds.num_tiles = int(meta["n_tiles"])
    ds.microscope_type = meta.get("microscope_type", "3D")
    ds.camera_model = meta.get("camera_model", "unknown")
    ds.tile_overlap = float(meta.get("tile_overlap", 0.2))
    ds.e_per_ADU = float(meta.get("e_per_ADU", 1.0))
    ds.na = float(meta.get("na", 1.35))
    ds.ri = float(meta.get("ri", 1.4))
    ds.binning = int(meta.get("binning", 1))
    ds.voxel_size_zyx_um = meta["voxel_size_zyx_um"]
    ds.codebook = raw_dir / "codebook.csv"
    ds.experiment_order = raw_dir / "exp_order.csv"

    noise_map = None
    noise_path = raw_dir / "noise_map.npy"
    if noise_path.exists():
        noise_map = np.load(noise_path)
        ds.noise_map = noise_map

    wavelengths = [meta["fiducial_wavelengths_um"][1]] + sorted(
        {tuple(w)[1] for w in meta["bit_wavelengths_um"]}
    )
    ds.channel_psfs = make_channel_psfs(
        wavelengths,
        na=ds.na,
        ri=ds.ri,
        voxel_size_zyx_um=ds.voxel_size_zyx_um,
        shape_zyx=tuple(meta.get("psf_shape_zyx", (15, 15, 15))),
        model=psf_model,
    )
    state = ds.datastore_state
    state.update({"Calibrations": True})
    ds.datastore_state = state

    def correct(img):
        if hotpixel_correction and noise_map is not None:
            return replace_hot_pixels(noise_map, img, threshold=hot_pixel_threshold)
        return np.asarray(img, np.uint16)

    stage_positions = meta.get("stage_positions_zyx_um")
    for tile_idx in range(int(meta["n_tiles"])):
        tdir = raw_dir / f"tile{tile_idx:04d}"
        ds.initialize_tile(tile_idx)
        stage = (
            stage_positions[tile_idx] if stage_positions else [0.0, 0.0, 0.0]
        )
        for r in range(int(meta["n_rounds"])):
            for ext in (".npy", ".tif", ".tiff"):
                p = tdir / f"fiducial_round{r + 1:03d}{ext}"
                if p.exists():
                    break
            img = correct(load_stack(p))
            ds.save_local_corrected_image(
                img, tile=tile_idx, round=r, psf_idx=0,
                hotpixel_correction=hotpixel_correction,
            )
            ds.save_local_stage_position_zyx_um(stage, tile=tile_idx, round=r)
            ds.save_local_wavelengths_um(
                tuple(meta["fiducial_wavelengths_um"]), tile=tile_idx, round=r
            )
        for b in range(int(meta["n_bits"])):
            for ext in (".npy", ".tif", ".tiff"):
                p = tdir / f"bit{b + 1:03d}{ext}"
                if p.exists():
                    break
            img = correct(load_stack(p))
            wl = tuple(meta["bit_wavelengths_um"][b])
            ds.save_local_corrected_image(
                img, tile=tile_idx, bit=b,
                psf_idx=1 if wl[0] < 0.600 else 2,
                hotpixel_correction=hotpixel_correction,
            )
            ds.save_local_wavelengths_um(wl, tile=tile_idx, bit=b)
    state = ds.datastore_state
    state.update({"Corrected": True})
    ds.datastore_state = state
    return ds


def _first_dataset_dir(
    root_path: Path, root_name: str, round_idx: int, tile_idx: int
) -> Path:
    """First raw NDTiff directory for a round/tile — qi2lab acquisitions end
    in ``_1`` or ``_2`` (reference `create_datastore.py:42-74`)."""
    base = f"{root_name}_r{round_idx + 1:04d}_tile{tile_idx:04d}"
    for suffix in ("_1", "_2"):
        candidate = root_path / f"{base}{suffix}"
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"no raw NDTiff dataset for {base} under {root_path}")


def _camera_parameters(ndtiff_metadata: dict) -> tuple[str, float, float]:
    """(camera model, e_per_ADU, offset) from per-image NDTiff metadata
    (reference `create_datastore.py:100-119`)."""
    camera_id = ndtiff_metadata.get("Camera-CameraName")
    camera_id_alt = ndtiff_metadata.get("Core-Camera")
    if "C13440-20CU" in (camera_id, camera_id_alt):
        return (
            "orcav3",
            float(ndtiff_metadata["Camera-CONVERSION FACTOR COEFF"]),
            float(ndtiff_metadata["Camera-CONVERSION FACTOR OFFSET"]),
        )
    if "Blackfly S BFS-U3-200S6M" in (camera_id, camera_id_alt):
        return "flir", 0.03, 0.0
    raise ValueError(f"unsupported camera metadata: {camera_id!r}/{camera_id_alt!r}")


def _camera_binning(metadata: dict, ndtiff_metadata: dict, camera: str) -> int:
    """Binning from scan metadata, else from per-image NDTiff metadata
    (reference `create_datastore.py:122-141`)."""
    try:
        return int(metadata["binning"])
    except (KeyError, TypeError, ValueError):
        pass
    key = "Camera-Binning" if camera == "orcav3" else "Binning"
    return int(str(ndtiff_metadata[key]).split("x")[0])


def _stage_position_zyx_um(
    position_list: np.ndarray, tile_idx: int, ndtiff_metadata: dict
) -> np.ndarray:
    """Stage zyx position with the qi2lab XYStage mirror correction
    (reference `create_datastore.py:156-182`)."""
    mirror_x = int(ndtiff_metadata.get("XYStage-TransposeMirrorX", 0)) == 1
    mirror_y = int(ndtiff_metadata.get("XYStage-TransposeMirrorY", 0)) == 1
    if mirror_x or mirror_y:
        corrected_y = np.max(position_list[:, 2]) - position_list[tile_idx, 2]
        corrected_x = np.max(position_list[:, 1]) - position_list[tile_idx, 1]
    else:
        corrected_y = position_list[tile_idx, 1]
        corrected_x = position_list[tile_idx, 2]
    return np.asarray(
        [
            np.round(position_list[tile_idx, 0], 2),
            np.round(corrected_y, 2),
            np.round(corrected_x, 2),
        ],
        dtype=np.float32,
    )


def create_datastore_qi2lab(
    root_path: Path,
    *,
    output_path: Path | None = None,
    channel_names: list[str] | None = None,
    codebook_path: Path | None = None,
    bit_order_path: Path | None = None,
    fallback_na: float = 1.35,
    fallback_ri: float = 1.51,
    excitation_wavelengths_um: tuple[float, ...] = (0.488, 0.561, 0.635),
    emission_wavelengths_um: tuple[float, ...] = (0.520, 0.580, 0.670),
    default_tile_overlap: float = 0.2,
    noise_map_shape_yx: tuple[int, int] = (2048, 2048),
    hot_pixel_threshold: float = 100.0,
    psf_model: str = "gaussian",
    psf_yx_size: int = 51,
    apply_flatfield: bool = True,
    max_flatfield_images: int = 100,
):
    """qi2lab microscope NDTiff acquisition → qi2lab datastore.

    Mirrors the reference conversion end to end
    (`cli/qi2lab_microscopes/create_datastore.py:185-600`): scan_metadata.csv
    drives the loop, camera identity/gain/offset/binning and stage positions
    come from the per-image NDTiff metadata, channel order is un-reversed
    when acquired red→blue, and fiducial/readout channels land in the
    datastore with the qi2lab round↔bit linkage from bit_order.csv.
    """
    import pandas as pd

    from ...datastore import qi2labDataStore
    from ...models.psf import make_channel_psfs
    from ...ops.filters import replace_hot_pixels
    from ...utils.dataio import read_metadatafile
    from ...utils.ndtiff import NDTiffDataset

    root_path = Path(root_path)
    if channel_names is None:
        channel_names = ["alexa488", "atto565", "alexa647"]
    codebook = pd.read_csv(codebook_path or root_path / "codebook.csv")
    experiment_order = pd.read_csv(
        bit_order_path or root_path / "bit_order.csv"
    ).values

    metadata = read_metadatafile(root_path / "scan_metadata.csv")
    root_name = str(metadata["root_name"])
    num_rounds = int(metadata["num_r"])
    num_tiles = int(metadata["num_xyz"])
    num_ch = int(metadata["num_ch"])

    first = NDTiffDataset(_first_dataset_dir(root_path, root_name, 0, 0))
    channel_to_test = first.get_image_coordinates_list()[0]["channel"]
    ndtiff_metadata = first.read_metadata(channel=channel_to_test, z=0)
    camera, e_per_ADU, offset = _camera_parameters(ndtiff_metadata)
    binning = _camera_binning(metadata, ndtiff_metadata, camera)
    channels_active = [
        metadata.get("blue_active", True),
        metadata.get("yellow_active", True),
        metadata.get("red_active", True),
    ]

    if "channels_reversed" in metadata:
        channel_order = "reversed" if metadata["channels_reversed"] else "forward"
    else:
        channel_order = "forward" if channel_to_test == "F-Blue" else "reversed"

    try:
        voxel_size_zyx_um = [
            float(metadata["z_step_um"]),
            float(metadata["yx_pixel_um"]),
            float(metadata["yx_pixel_um"]),
        ]
    except (KeyError, TypeError, ValueError):
        yx_pixel_um = round(float(ndtiff_metadata["PixelSizeUm"]), 3)
        z_pixel_um = round(
            abs(
                float(first.read_metadata(channel=channel_to_test, z=1)[
                    "ZPosition_um_Intended"
                ])
                - float(ndtiff_metadata["ZPosition_um_Intended"])
            ),
            3,
        )
        voxel_size_zyx_um = [z_pixel_um, yx_pixel_um, yx_pixel_um]

    na = float(metadata.get("na", fallback_na) or fallback_na)
    ri = float(metadata.get("ri", fallback_ri) or fallback_ri)
    channels_in_data = list(compress(range(num_ch), channels_active))

    noise_map = float(offset) * np.ones(
        tuple(int(v) for v in noise_map_shape_yx), dtype=np.uint16
    )

    # camera-to-stage orientation: PixelSizeAffine (µm) → unit-pixel 4×4
    # (reference `create_datastore.py:371-387`).
    affine_zyx_px = np.eye(4, dtype=np.float32)
    if "PixelSizeAffine" in ndtiff_metadata:
        vals = np.asarray(
            [float(v) for v in str(ndtiff_metadata["PixelSizeAffine"]).split(";")],
            dtype=np.float32,
        )
        vals = np.round(vals / float(ndtiff_metadata.get("PixelSizeUm", 1.0)), 2)
        affine_zyx_px = np.array(
            [
                [1, 0, 0, 0],
                [0, vals[4], vals[3], 0],
                [0, vals[1], vals[0], 0],
                [0, 0, 0, 1],
            ],
            dtype=np.float32,
        )

    psf_z = max(len(first.axis_values("z")), 1)
    channel_psfs = make_channel_psfs(
        [emission_wavelengths_um[c] for c in channels_in_data],
        na=na,
        ri=ri,
        voxel_size_zyx_um=voxel_size_zyx_um,
        shape_zyx=(psf_z, psf_yx_size, psf_yx_size),
        model=psf_model,
    )

    datastore_path = (
        Path(output_path) if output_path is not None
        else root_path / "qi2labdatastore"
    )
    ds = qi2labDataStore(datastore_path)
    ds.channels_in_data = channel_names
    ds.num_rounds = num_rounds
    ds.codebook = codebook
    ds.experiment_order = experiment_order
    ds.num_tiles = num_tiles
    microscope_type = metadata.get("experiment_type")
    ds.microscope_type = microscope_type or (
        "3D" if voxel_size_zyx_um[0] < 0.5 else "2D"
    )
    ds.camera_model = camera
    ds.tile_overlap = float(metadata.get("tile_overlap", default_tile_overlap)
                            or default_tile_overlap)
    ds.e_per_ADU = e_per_ADU
    ds.na = na
    ds.ri = ri
    ds.binning = binning
    ds.noise_map = noise_map
    ds.voxel_size_zyx_um = voxel_size_zyx_um
    ds.channel_psfs = channel_psfs
    state = ds.datastore_state
    state.update({"Calibrations": True})
    ds.datastore_state = state

    correct_shape = None
    for round_idx in range(num_rounds):
        datasets = [
            NDTiffDataset(
                _first_dataset_dir(root_path, root_name, round_idx, tile_idx)
            )
            for tile_idx in range(num_tiles)
        ]
        position_list = np.asarray(
            [
                [
                    round(float(d.read_metadata(channel=channel_to_test, z=0)[
                        f"{ax}Position_um_Intended"
                    ]), 2)
                    for ax in ("Z", "Y", "X")
                ]
                for d in datasets
            ]
        )

        for tile_idx, dataset in enumerate(datasets):
            if round_idx == 0:
                ds.initialize_tile(tile_idx)
            raw_image = dataset.as_array()  # (channel, z, y, x)
            if correct_shape is None:
                correct_shape = raw_image.shape
            if raw_image.shape != correct_shape:
                if raw_image.shape[0] < correct_shape[0]:
                    raw_image = np.zeros(correct_shape, dtype=np.uint16)
                else:
                    trim = raw_image.shape[1] - correct_shape[1]
                    raw_image = raw_image[:, trim:, :].copy()
            if channel_order == "reversed":
                raw_image = np.flip(raw_image, axis=0)

            raw_image = (raw_image.astype(np.float32) - offset) * e_per_ADU
            raw_image = np.clip(raw_image, 0.0, 2**16 - 1).astype(np.uint16)
            hot_pixel_corrected = False
            if camera == "flir":
                raw_image = replace_hot_pixels(noise_map, raw_image)
                raw_image = replace_hot_pixels(
                    np.max(raw_image, axis=0), raw_image,
                    threshold=hot_pixel_threshold,
                )
                hot_pixel_corrected = True

            ds.save_local_stage_position_zyx_um(
                _stage_position_zyx_um(position_list, tile_idx, ndtiff_metadata),
                tile=tile_idx,
                round=round_idx,
                affine_zyx_px=affine_zyx_px,
            )
            for channel_idx in range(num_ch):
                channel_image = np.squeeze(raw_image[channel_idx]).astype(np.uint16)
                wavelengths_um = (
                    excitation_wavelengths_um[channel_idx],
                    emission_wavelengths_um[channel_idx],
                )
                if channel_idx == 0:
                    ds.save_local_corrected_image(
                        channel_image, tile=tile_idx, round=round_idx,
                        psf_idx=0, gain_correction=True,
                        hotpixel_correction=hot_pixel_corrected,
                    )
                    ds.save_local_wavelengths_um(
                        wavelengths_um, tile=tile_idx, round=round_idx
                    )
                else:
                    bit_idx = int(experiment_order[round_idx, channel_idx]) - 1
                    ds.save_local_corrected_image(
                        channel_image, tile=tile_idx, bit=bit_idx,
                        psf_idx=channel_idx, gain_correction=True,
                        hotpixel_correction=hot_pixel_corrected,
                    )
                    ds.save_local_wavelengths_um(
                        wavelengths_um, tile=tile_idx, bit=bit_idx
                    )

    if apply_flatfield:
        _apply_flatfield_corrections(
            ds, max_flatfield_images=max_flatfield_images
        )

    state = ds.datastore_state
    state.update({"Corrected": True})
    ds.datastore_state = state
    return ds


def _apply_flatfield_corrections(
    ds, *, max_flatfield_images: int = 100, seed: int = 0
) -> None:
    """Estimate and divide out per-channel illumination flatfields
    (reference `create_datastore.py:600-710`, `use_illuminations=False`
    default path): sample up to ``max_flatfield_images`` tiles, fit a
    BaSiC flatfield (`utils/imageprocessing.estimate_shading`) on the
    round-0 fiducial images, divide it out of every fiducial stack, then
    repeat per readout bit. The stored correction provenance (psf_idx,
    gain/hotpixel flags) is preserved — only shading_correction flips."""
    from ...utils.imageprocessing import estimate_shading

    n_sample = min(int(ds.num_tiles), int(max_flatfield_images))
    rng = np.random.default_rng(seed)
    sample = rng.choice(ds.num_tiles, size=n_sample, replace=False)

    def _divide_and_save(img: np.ndarray, flat: np.ndarray, **where) -> None:
        corrected = (
            (np.asarray(img).astype(np.float32) / flat)
            .clip(0, 2**16 - 1)
            .astype(np.uint16)
        )
        # preserve the stored correction provenance (psf_idx, gain/hotpixel
        # flags) — this pass only adds shading correction
        prior = ds.load_local_corrected_image_attrs(**where)
        ds.save_local_corrected_image(
            corrected,
            psf_idx=int(prior.get("psf_idx", 0)),
            gain_correction=bool(prior.get("gain_correction", True)),
            hotpixel_correction=bool(prior.get("hotpixel_correction", False)),
            shading_correction=True,
            **where,
        )

    fiducial_stack = np.stack(
        [
            np.asarray(ds.load_local_corrected_image(tile=int(t), round=0))
            for t in sample
        ]
    )
    fiducial_flat = estimate_shading(fiducial_stack)
    for round_idx in range(ds.num_rounds):
        for tile_idx in range(ds.num_tiles):
            _divide_and_save(
                ds.load_local_corrected_image(tile=tile_idx, round=round_idx),
                fiducial_flat,
                tile=tile_idx,
                round=round_idx,
            )

    for bit_idx, bit_id in enumerate(ds.bit_ids):
        readout_stack = np.stack(
            [
                np.asarray(ds.load_local_corrected_image(tile=int(t), bit=bit_idx))
                for t in sample
            ]
        )
        readout_flat = estimate_shading(readout_stack)
        for tile_idx in range(ds.num_tiles):
            _divide_and_save(
                ds.load_local_corrected_image(tile=tile_idx, bit=bit_idx),
                readout_flat,
                tile=tile_idx,
                bit=bit_idx,
            )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qi2lab-datastore")
    p.add_argument("--raw-dir", required=True, type=Path)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--layout", choices=("auto", "generic", "qi2lab"), default="auto")
    p.add_argument("--hotpixel-correction", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--hot-pixel-threshold", type=float, default=375.0)
    p.add_argument("--psf-model", choices=("gaussian", "born_wolf", "vectorial"), default="gaussian")
    p.add_argument("--codebook-path", type=Path, default=None)
    p.add_argument("--bit-order-path", type=Path, default=None)
    # reference `use_illuminations=False` default = estimate+apply BaSiC
    # flatfields after conversion (`create_datastore.py:600-710`)
    p.add_argument(
        "--apply-flatfield", action=argparse.BooleanOptionalAction, default=True
    )
    p.add_argument("--max-flatfield-images", type=int, default=100)
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    layout = args.layout
    if layout == "auto":
        layout = "qi2lab" if (args.raw_dir / "scan_metadata.csv").exists() else "generic"
    if layout == "qi2lab":
        create_datastore_qi2lab(
            args.raw_dir,
            output_path=(
                args.output_dir / "qi2labdatastore" if args.output_dir else None
            ),
            codebook_path=args.codebook_path,
            bit_order_path=args.bit_order_path,
            hot_pixel_threshold=args.hot_pixel_threshold,
            psf_model=args.psf_model,
            apply_flatfield=args.apply_flatfield,
            max_flatfield_images=args.max_flatfield_images,
        )
        return
    if args.output_dir is None:
        p.error("--output-dir is required for the generic layout")
    create_datastore(
        args.raw_dir,
        args.output_dir,
        hotpixel_correction=args.hotpixel_correction,
        hot_pixel_threshold=args.hot_pixel_threshold,
        psf_model=args.psf_model,
    )


if __name__ == "__main__":
    main()
