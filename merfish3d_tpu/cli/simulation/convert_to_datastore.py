"""sim-datastore: raw acquisition layout → qi2lab datastore.

Mirrors `cli/statphysbio_simulation/convert_to_datastore.py` including the
**synthetic chromatic aberration injection** option
(reference `convert_to_datastore.py:42-183`): bits of the non-reference
emission wavelength are warped by a known chromatic affine before being
stored, so the decode-time chromatic estimator can be validated end-to-end.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import pandas as pd


def make_injection_affine(
    z_shift_um: float = 0.18,
    yx_scale: float = 0.9982,
    y_shift_um: float = 0.42,
    x_shift_um: float = -0.31,
) -> np.ndarray:
    affine = np.eye(4)
    affine[0, 3] = z_shift_um
    affine[1, 1] = yx_scale
    affine[1, 3] = y_shift_um
    affine[2, 2] = yx_scale
    affine[2, 3] = x_shift_um
    return affine


def convert_data(
    raw_dir: Path,
    datastore_parent: Path,
    *,
    inject_chromatic_aberration: bool = False,
    injection_affine: np.ndarray | None = None,
):
    from ...datastore import qi2labDataStore
    from ...models.psf import make_channel_psfs
    from ...ops.warp import warp_affine

    raw_dir = Path(raw_dir)
    meta = json.loads((raw_dir / "metadata.json").read_text())
    ds = qi2labDataStore(Path(datastore_parent) / "qi2labdatastore")
    ds.channels_in_data = ["fiducial", "readout1", "readout2"]
    ds.num_tiles = int(meta["n_tiles"])
    ds.microscope_type = "3D"
    ds.tile_overlap = 0.2
    ds.e_per_ADU = 1.0
    ds.na = float(meta.get("na", 1.35))
    ds.ri = float(meta.get("ri", 1.4))
    ds.binning = 1
    ds.voxel_size_zyx_um = meta["voxel_size_zyx_um"]
    ds.codebook = raw_dir / "codebook.csv"
    ds.experiment_order = raw_dir / "exp_order.csv"
    wavelengths = [meta["fiducial_wavelengths_um"][1]] + sorted(
        {tuple(w)[1] for w in meta["bit_wavelengths_um"]}
    )
    ds.channel_psfs = make_channel_psfs(
        wavelengths,
        na=ds.na,
        ri=ds.ri,
        voxel_size_zyx_um=ds.voxel_size_zyx_um,
        shape_zyx=(15, 15, 15),
    )
    state = ds.datastore_state
    state.update({"Calibrations": True})
    ds.datastore_state = state

    spacing = np.asarray(meta["voxel_size_zyx_um"])
    if inject_chromatic_aberration and injection_affine is None:
        injection_affine = make_injection_affine()
    reference_wl = sorted({tuple(w)[1] for w in meta["bit_wavelengths_um"]})[0]

    n_bits = int(meta["n_bits"])
    n_rounds = int(meta["n_rounds"])
    for tile_idx in range(int(meta["n_tiles"])):
        tdir = raw_dir / f"tile{tile_idx:04d}"
        ds.initialize_tile(tile_idx)
        stage = (
            meta.get("stage_positions_zyx_um", [[0, 0, 0]] * int(meta["n_tiles"]))
        )[tile_idx]
        for r in range(n_rounds):
            img = np.load(tdir / f"fiducial_round{r + 1:03d}.npy")
            ds.save_local_corrected_image(img, tile=tile_idx, round=r, psf_idx=0)
            ds.save_local_stage_position_zyx_um(stage, tile=tile_idx, round=r)
            ds.save_local_wavelengths_um(
                tuple(meta["fiducial_wavelengths_um"]), tile=tile_idx, round=r
            )
        for b in range(n_bits):
            img = np.load(tdir / f"bit{b + 1:03d}.npy").astype(np.float32)
            wl = tuple(meta["bit_wavelengths_um"][b])
            if inject_chromatic_aberration and not np.isclose(wl[1], reference_wl):
                # store stored(p) = true(A·p): decode applies inv(chromatic)
                # (`decode_warping.compose_decode_warp_transform_zyx_um`), so
                # the calibration that undoes this injection equals A itself
                img = warp_affine(
                    img,
                    transform_zyx_um=injection_affine,
                    spacing_zyx_um=spacing,
                    reference_shape=img.shape,
                )
            ds.save_local_corrected_image(
                np.clip(img, 0, 65535).astype(np.uint16),
                tile=tile_idx,
                bit=b,
                psf_idx=1 if wl[0] < 0.600 else 2,
            )
            ds.save_local_wavelengths_um(wl, tile=tile_idx, bit=b)
    state = ds.datastore_state
    state.update({"Corrected": True})
    ds.datastore_state = state
    if inject_chromatic_aberration:
        (Path(datastore_parent) / "injected_chromatic_affine.json").write_text(
            json.dumps(np.asarray(injection_affine).tolist())
        )
    return ds


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sim-datastore")
    p.add_argument("--input-dir", required=True, type=Path)
    p.add_argument("--output-dir", required=True, type=Path)
    p.add_argument(
        "--inject-chromatic-aberration",
        action=argparse.BooleanOptionalAction,
        default=False,
    )
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    convert_data(
        args.input_dir,
        args.output_dir,
        inject_chromatic_aberration=args.inject_chromatic_aberration,
    )


if __name__ == "__main__":
    main()
