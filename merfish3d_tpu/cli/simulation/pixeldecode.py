"""sim-decode: pixel decoding with simulation defaults.

Mirrors `cli/statphysbio_simulation/pixeldecode.py:197-316`: magnitude
default (0.9, 10.0), minimum pixels 28 (3D simulation), blank-fraction
filter.
"""

from __future__ import annotations

import argparse
from pathlib import Path

SIM_DEFAULT_MAGNITUDE_THRESHOLD = (0.9, 10.0)
SIM_3D_DEFAULT_MINIMUM_PIXELS = 28


def decode_pixels(
    datastore_path,
    *,
    minimum_pixels: int = SIM_3D_DEFAULT_MINIMUM_PIXELS,
    magnitude_threshold=SIM_DEFAULT_MAGNITUDE_THRESHOLD,
    num_tiles: int = 20,
    num_iterations: int = 3,
    filter_method: str = "blank_fraction",
    target_misid_rate: float = 0.05,
    estimate_chromatic_affines: bool = False,
    lowpass_sigma=(3.0, 1.0, 1.0),
):
    from ...datastore import qi2labDataStore
    from ...pipeline.decoder import PixelDecoder

    ds = qi2labDataStore(datastore_path, validate=False)
    decoder = PixelDecoder(
        ds,
        magnitude_threshold=tuple(magnitude_threshold),
        minimum_pixels=minimum_pixels,
        estimate_chromatic_affines=estimate_chromatic_affines,
        verbose=0,
    )
    decoder.optimize_normalization_by_decoding(
        n_random_tiles=num_tiles,
        n_iterations=num_iterations,
        lowpass_sigma=tuple(lowpass_sigma),
    )
    return decoder.decode_all_tiles(
        lowpass_sigma=tuple(lowpass_sigma),
        filter_method=filter_method,
        target_misid_rate=target_misid_rate,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sim-decode")
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--minimum-pixels", type=int, default=SIM_3D_DEFAULT_MINIMUM_PIXELS)
    p.add_argument("--magnitude-threshold", type=float, nargs=2, default=SIM_DEFAULT_MAGNITUDE_THRESHOLD)
    p.add_argument("--num-tiles", type=int, default=20)
    p.add_argument("--num-iterations", type=int, default=3)
    p.add_argument("--filter-method", choices=("blank_fraction", "lr", "none"), default="blank_fraction")
    p.add_argument("--target-misid-rate", type=float, default=0.05)
    p.add_argument("--estimate-chromatic-affines", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--lowpass-sigma", type=float, nargs=3, default=(3.0, 1.0, 1.0))
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    decode_pixels(
        args.datastore_path,
        minimum_pixels=args.minimum_pixels,
        magnitude_threshold=args.magnitude_threshold,
        num_tiles=args.num_tiles,
        num_iterations=args.num_iterations,
        filter_method=args.filter_method,
        target_misid_rate=args.target_misid_rate,
        estimate_chromatic_affines=args.estimate_chromatic_affines,
        lowpass_sigma=args.lowpass_sigma,
    )


if __name__ == "__main__":
    main()
