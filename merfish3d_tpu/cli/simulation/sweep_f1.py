"""sim-sweep: decode-parameter sweep with F1 scoring per grid point
(mirrors `cli/statphysbio_simulation/sweep_f1.py:293-384`,
``sweep_decode_params``): a 3-axis grid over minimum pixels, magnitude
thresholds, and feature-predictor thresholds, decoding per point and
writing results incrementally to ``decode_params_results.json`` (each
point's failure is captured, not fatal), plus an optional CSV table.

Normalization vectors are optimized ONCE up front and reused across grid
points (they do not depend on the swept thresholds), so the sweep is
decode-only per point like the reference's.

``feature_predictor_threshold`` is accepted for grid compatibility with
the reference but is a documented legacy no-op there too — the decoder
weights by the probability image rather than thresholding it
(reference `PixelDecoder.py:1485-1487`).
"""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

import pandas as pd


def sweep(
    datastore_path: Path,
    ground_truth_csv: Path,
    *,
    magnitude_lows=(0.7, 0.9, 1.1),
    minimum_pixels_grid=(16, 28, 40),
    feature_predictor_thresholds=(0.1,),
    radius_um: float = 1.0,
    output_csv: Path | None = None,
    results_json: Path | None = None,
    optimize_tiles: int = 5,
    optimize_iterations: int = 2,
    verbose: int = 1,
) -> pd.DataFrame:
    from ...datastore import qi2labDataStore
    from ...pipeline.decoder import PixelDecoder
    from .calculate_f1 import match_spots_f1

    gt = pd.read_csv(ground_truth_csv)
    ds = qi2labDataStore(datastore_path, validate=False)

    # one normalization optimization shared by every grid point
    base = PixelDecoder(ds, verbose=0)
    base.optimize_normalization_by_decoding(
        n_random_tiles=optimize_tiles, n_iterations=optimize_iterations
    )

    if results_json is None:
        results_json = Path(datastore_path) / "decode_params_results.json"
    results: dict[str, dict] = {}

    rows = []
    for min_px, fp_thr, mag_lo in itertools.product(
        minimum_pixels_grid, feature_predictor_thresholds, magnitude_lows
    ):
        params = {
            "min_pixels": round(float(min_px), 2),
            "mag_lower_thresh": round(float(mag_lo), 2),
            "mag_upper_thresh": 10.0,
            "feature_predictor_threshold": round(float(fp_thr), 2),
        }
        try:
            decoder = PixelDecoder(
                ds,
                magnitude_threshold=(float(mag_lo), 10.0),
                minimum_pixels=float(min_px),
                verbose=0,
            )
            df = decoder.decode_all_tiles(filter_method="blank_fraction")
            score = match_spots_f1(df, gt, radius_um=radius_um)
            result = {
                k: score[k]
                for k in (
                    "f1",
                    "precision",
                    "recall",
                    "true_positives",
                    "false_positives",
                    "false_negatives",
                    "n_decoded",
                )
            }
        except Exception as exc:  # per-point failures recorded, not fatal
            result = {"error": str(exc)}
        results[str(params)] = result
        # incremental checkpoint after every grid point (reference
        # `sweep_f1.py:380-382`)
        results_json.parent.mkdir(parents=True, exist_ok=True)
        results_json.write_text(json.dumps(results, indent=2))
        row = {**params, **result}
        rows.append(row)
        if verbose:
            print(json.dumps(row), flush=True)

    result_df = pd.DataFrame(rows)
    if output_csv is not None:
        result_df.to_csv(output_csv, index=False)
    return result_df


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sim-sweep")
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--ground-truth", required=True, type=Path)
    p.add_argument("--magnitude-lows", type=float, nargs="+", default=(0.7, 0.9, 1.1))
    p.add_argument("--minimum-pixels-grid", type=int, nargs="+", default=(16, 28, 40))
    p.add_argument(
        "--feature-predictor-thresholds", type=float, nargs="+", default=(0.1,)
    )
    p.add_argument("--radius-um", type=float, default=1.0)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--results-json", type=Path, default=None)
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    sweep(
        args.datastore_path,
        args.ground_truth,
        magnitude_lows=tuple(args.magnitude_lows),
        minimum_pixels_grid=tuple(args.minimum_pixels_grid),
        feature_predictor_thresholds=tuple(args.feature_predictor_thresholds),
        radius_um=args.radius_um,
        output_csv=args.output,
        results_json=args.results_json,
    )


if __name__ == "__main__":
    main()
