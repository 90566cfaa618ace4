"""qi2lab-decode: full pixel-decoding CLI with Nyquist-aware defaults.

Mirrors `cli/qi2lab_microscopes/pixeldecode.py:25-483`: sampling-aware
default thresholds keyed by the axial Nyquist multiple, normalization
optimization knobs (default 20 tiles × 5 iterations), filter method, and
the optional RNA-derived chromatic-affine estimation.
"""

from __future__ import annotations

import argparse
from pathlib import Path

QI2LAB_3D_DEFAULT_MAGNITUDE_THRESHOLD = (1.5, 10.0)
QI2LAB_2D_DEFAULT_MINIMUM_PIXELS = 7
QI2LAB_3D_DEFAULT_MINIMUM_PIXELS = 16
QI2LAB_2D_MAGNITUDE_THRESHOLD_BY_NYQUIST = {3.0: 0.7, 5.0: 0.2}
QI2LAB_2D_DECON_FEATURE_PREDICTOR_THRESHOLD_BY_NYQUIST = {3.0: 0.3, 5.0: 0.2}
QI2LAB_AXIAL_NYQUIST_STEP_UM = 0.315
QI2LAB_DEFAULT_FEATURE_PREDICTOR_THRESHOLD = 0.5


def _nearest_nyquist_multiple(table: dict, multiple: float) -> float:
    keys = sorted(table)
    return min(keys, key=lambda k: abs(k - multiple))


def effective_decode_mode(datastore, decode_mode: str = "auto") -> str:
    if decode_mode in ("2d", "3d"):
        return decode_mode
    return "2d" if str(datastore.microscope_type) == "2D" else "3d"


def default_minimum_pixels(datastore, decode_mode: str = "auto") -> int:
    """reference `_default_qi2lab_minimum_pixels:97-121`."""
    if effective_decode_mode(datastore, decode_mode) == "2d":
        return QI2LAB_2D_DEFAULT_MINIMUM_PIXELS
    return QI2LAB_3D_DEFAULT_MINIMUM_PIXELS


def default_magnitude_threshold(datastore, decode_mode: str = "auto"):
    """reference `_default_qi2lab_magnitude_threshold:122-160`."""
    if effective_decode_mode(datastore, decode_mode) != "2d":
        return QI2LAB_3D_DEFAULT_MAGNITUDE_THRESHOLD
    z_step = float(datastore.voxel_size_zyx_um[0])
    multiple = z_step / QI2LAB_AXIAL_NYQUIST_STEP_UM
    nearest = _nearest_nyquist_multiple(
        QI2LAB_2D_MAGNITUDE_THRESHOLD_BY_NYQUIST, multiple
    )
    return (
        QI2LAB_2D_MAGNITUDE_THRESHOLD_BY_NYQUIST[nearest],
        QI2LAB_3D_DEFAULT_MAGNITUDE_THRESHOLD[1],
    )


def default_feature_predictor_threshold(datastore, decode_mode: str = "auto") -> float:
    """reference `_default_qi2lab_feature_predictor_threshold:162-218`."""
    if effective_decode_mode(datastore, decode_mode) != "2d":
        return QI2LAB_DEFAULT_FEATURE_PREDICTOR_THRESHOLD
    z_step = float(datastore.voxel_size_zyx_um[0])
    multiple = z_step / QI2LAB_AXIAL_NYQUIST_STEP_UM
    nearest = _nearest_nyquist_multiple(
        QI2LAB_2D_DECON_FEATURE_PREDICTOR_THRESHOLD_BY_NYQUIST, multiple
    )
    return QI2LAB_2D_DECON_FEATURE_PREDICTOR_THRESHOLD_BY_NYQUIST[nearest]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qi2lab-decode", description="Pixel decode a qi2lab datastore"
    )
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--decode-mode", choices=("auto", "2d", "3d"), default="auto")
    p.add_argument("--merfish-bits", type=int, default=None)
    p.add_argument("--minimum-pixels", type=int, default=None)
    p.add_argument("--maximum-pixels", type=int, default=500)
    p.add_argument("--magnitude-threshold", type=float, nargs=2, default=None)
    p.add_argument("--lowpass-sigma", type=float, nargs=3, default=(3.0, 1.0, 1.0))
    p.add_argument("--num-tiles", type=int, default=20, help="optimization sample tiles")
    p.add_argument("--num-iterations", type=int, default=5)
    p.add_argument("--filter-method", choices=("blank_fraction", "lr", "none"), default="blank_fraction")
    p.add_argument("--target-misid-rate", type=float, default=0.05)
    p.add_argument("--estimate-chromatic-affines", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--assign-to-cells", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--include-blanks", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--z-range", type=int, nargs=2, default=None)
    p.add_argument("--decode-run-key", type=str, default=None)
    p.add_argument(
        "--num-gpus", type=int, default=0,
        help="devices for tile fan-out (0 = all visible)",
    )
    p.add_argument(
        "--optimize-filtering-only",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="re-filter existing per-tile decodes without re-decoding "
        "(reference optimize_filtering re-entry)",
    )
    return p


def decode_pixels(args) -> None:
    from ...datastore import qi2labDataStore
    from ...pipeline.decoder import PixelDecoder

    datastore = qi2labDataStore(args.datastore_path, validate=False)
    mode = effective_decode_mode(datastore, args.decode_mode)
    minimum_pixels = (
        args.minimum_pixels
        if args.minimum_pixels is not None
        else default_minimum_pixels(datastore, args.decode_mode)
    )
    magnitude_threshold = (
        tuple(args.magnitude_threshold)
        if args.magnitude_threshold is not None
        else default_magnitude_threshold(datastore, args.decode_mode)
    )
    decoder = PixelDecoder(
        datastore,
        merfish_bits=args.merfish_bits,
        z_range=tuple(args.z_range) if args.z_range else None,
        include_blanks=args.include_blanks,
        is_3D=(mode == "3d"),
        magnitude_threshold=magnitude_threshold,
        minimum_pixels=minimum_pixels,
        maximum_pixels=args.maximum_pixels,
        decode_run_key=args.decode_run_key,
        num_devices=args.num_gpus,
        estimate_chromatic_affines=args.estimate_chromatic_affines,
    )
    if args.optimize_filtering_only:
        decoder.optimize_filtering(
            filter_method=args.filter_method,
            target_misid_rate=args.target_misid_rate,
        )
        return
    decoder.optimize_normalization_by_decoding(
        n_random_tiles=args.num_tiles,
        n_iterations=args.num_iterations,
        lowpass_sigma=tuple(args.lowpass_sigma),
    )
    decoder.decode_all_tiles(
        assign_to_cells=args.assign_to_cells,
        lowpass_sigma=tuple(args.lowpass_sigma),
        filter_method=args.filter_method,
        target_misid_rate=args.target_misid_rate,
    )


def main(argv=None) -> None:
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    decode_pixels(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
