"""qi2lab-chromatic-calibration: bead-based chromatic calibration
(mirrors `cli/qi2lab_microscopes/chromatic_calibration.py`)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qi2lab-chromatic-calibration")
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument(
        "--bead-stacks", type=Path, nargs="+", default=None,
        help="one bead stack (.npy/.tif) per channel",
    )
    p.add_argument(
        "--bead-image", type=Path, default=None,
        help="single multi-channel OME-TIFF bead acquisition (spacing + "
             "emission wavelengths parsed from the OME-XML, like the "
             "reference's chromatic.py:100-169 parse path)",
    )
    p.add_argument(
        "--wavelengths-um", type=float, nargs="+", default=None,
        help="emission wavelength per stack (overrides OME metadata)",
    )
    p.add_argument("--deconvolve", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--detection-threshold", type=float, default=0.5)
    p.add_argument(
        "--ufish-model", type=str, default="simfish",
        help="U-FISH model alias for bead detection (DoG fallback when no "
             "checkpoint is resolvable)",
    )
    p.add_argument("--ufish-checkpoint", type=Path, default=None)
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    if (args.bead_stacks is None) == (args.bead_image is None):
        raise SystemExit("pass exactly one of --bead-stacks / --bead-image")

    from ...datastore import qi2labDataStore
    from ...utils.chromatic_calibration import run_chromatic_calibration
    from ...utils.dataio import load_stack

    ds = qi2labDataStore(args.datastore_path, validate=False)
    wavelengths = args.wavelengths_um
    bead_spacing = None  # bead-acquisition voxel size, when it differs
    if args.bead_image is not None:
        from ...utils.ometiff import read_ome_tiff_stack

        stack, bead_spacing, meta_wl = read_ome_tiff_stack(args.bead_image)
        volumes = list(stack)
        if wavelengths is None:
            wavelengths = meta_wl
        if wavelengths is None:
            raise SystemExit(
                "bead OME-TIFF has no channel EmissionWavelength metadata; "
                "pass --wavelengths-um"
            )
    else:
        volumes = [load_stack(s) for s in args.bead_stacks]
        if wavelengths is None:
            raise SystemExit("--bead-stacks requires --wavelengths-um")
    if len(volumes) != len(wavelengths):
        raise SystemExit("bead channels and wavelengths must align")
    calibration = run_chromatic_calibration(
        ds, volumes, wavelengths,
        deconvolve=args.deconvolve,
        detection_threshold=args.detection_threshold,
        ufish_model=args.ufish_model,
        ufish_checkpoint=args.ufish_checkpoint,
        voxel_size_zyx_um=bead_spacing,
    )
    print(json.dumps({k: v.get("status") for k, v in calibration["channels"].items()}, indent=2))


if __name__ == "__main__":
    main()
