"""qi2lab-preprocess: local (+ optional global) registration CLI.

Mirrors the reference command surface
(`cli/qi2lab_microscopes/preprocess.py:28-261`): every
SOFIMA/global-registration/fusion config field is exposed as a flag.
argparse replaces Typer (not available in this environment); flag names
match the reference kebab-case surface.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qi2lab-preprocess",
        description="Local registration, deconvolution, and spot prediction",
    )
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--decon-fiducial", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--decon-readout", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--overwrite", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--deformable-registration", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--save-all-fiducial-registered", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument(
        "--num-gpus", type=int, default=0,
        help="number of devices to fan tiles across (0 = all visible chips)",
    )
    p.add_argument("--round-batch-size", type=int, default=4,
                   help="moving fiducial rounds resident per decon batch")
    p.add_argument(
        "--crop-yx-decon", type=int, default=None,
        help="RLGC lateral tile (default: auto from the HBM budget)",
    )
    p.add_argument("--ufish-model", type=str, default="simfish")
    p.add_argument("--ufish-checkpoint", type=Path, default=None)
    p.add_argument("--global-registration", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--global-registration-only", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--registration-diagnostics", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--decon-max-iters", type=int, default=40)
    # SOFIMA config (reference flag set, `preprocess.py:50-65`; the
    # subpixel_*/mesh_* integrator flags are superseded — see
    # SofimaRegistrationConfig's docstring for the mapping)
    p.add_argument("--sofima-residual-iterations", type=int, default=2)
    p.add_argument("--sofima-patch-size-zyx", type=int, nargs=3, default=(10, 32, 32))
    p.add_argument("--sofima-minimum-patch-size-px", type=int, default=4)
    p.add_argument("--sofima-step-divisor", type=int, default=2)
    p.add_argument("--sofima-stride-zyx", type=int, nargs=3, default=None,
                   help="explicit stride override of patch // step-divisor")
    p.add_argument("--sofima-peak-min-distance", type=int, default=2)
    p.add_argument("--sofima-peak-radius", type=int, default=8)
    p.add_argument("--sofima-batch-size", type=int, default=512)
    p.add_argument("--sofima-max-masked", type=float, default=0.75)
    p.add_argument("--sofima-min-peak-ratio", type=float, default=1.2)
    p.add_argument("--sofima-min-peak-sharpness", type=float, default=1.2)
    p.add_argument("--sofima-max-magnitude", type=float, default=30.0)
    p.add_argument("--sofima-max-deviation", type=float, default=5.0)
    p.add_argument("--sofima-max-local-z-displacement-px", type=float, default=5.0)
    p.add_argument("--sofima-normalization-epsilon", type=float, default=1e-6)
    # Global registration / fusion configs
    p.add_argument("--global-binning-zyx", type=int, nargs=3, default=(3, 6, 6))
    p.add_argument("--global-transform-type", type=str, default="translation")
    p.add_argument("--global-keep-axis-aligned", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--global-quality-threshold", type=float, default=0.2)
    p.add_argument("--fusion-chunk-px", type=int, default=512)
    p.add_argument("--fusion-overlap-px", type=int, default=64)
    return p


def local_register_data(args) -> None:
    from ...datastore import qi2labDataStore
    from ...ops.flow import SofimaRegistrationConfig
    from ...pipeline.registration import (
        DataRegistration,
        GlobalFusionConfig,
        GlobalRegistrationConfig,
    )

    datastore = qi2labDataStore(args.datastore_path)
    reg = DataRegistration(
        datastore,
        decon_fiducial=args.decon_fiducial,
        decon_readout=args.decon_readout,
        overwrite=args.overwrite,
        deformable_registration=args.deformable_registration,
        save_all_fiducial_registered=args.save_all_fiducial_registered,
        crop_yx_decon=args.crop_yx_decon,
        ufish_model=args.ufish_model,
        ufish_checkpoint=args.ufish_checkpoint,
        global_registration=args.global_registration,
        sofima_config=SofimaRegistrationConfig(
            residual_iterations=args.sofima_residual_iterations,
            patch_size_zyx=tuple(args.sofima_patch_size_zyx),
            minimum_patch_size_px=args.sofima_minimum_patch_size_px,
            step_divisor=args.sofima_step_divisor,
            stride_zyx=(
                tuple(args.sofima_stride_zyx)
                if args.sofima_stride_zyx is not None else None
            ),
            peak_min_distance=args.sofima_peak_min_distance,
            peak_radius=args.sofima_peak_radius,
            batch_size=args.sofima_batch_size,
            max_masked=args.sofima_max_masked,
            min_peak_ratio=args.sofima_min_peak_ratio,
            min_peak_sharpness=args.sofima_min_peak_sharpness,
            max_magnitude=args.sofima_max_magnitude,
            max_deviation=args.sofima_max_deviation,
            max_local_z_displacement_px=args.sofima_max_local_z_displacement_px,
            normalization_epsilon=args.sofima_normalization_epsilon,
        ),
        global_registration_config=GlobalRegistrationConfig(
            binning_zyx=tuple(args.global_binning_zyx),
            transform_type=args.global_transform_type,
            keep_axis_aligned=args.global_keep_axis_aligned,
            quality_threshold=args.global_quality_threshold,
        ),
        global_fusion_config=GlobalFusionConfig(
            chunk_px=args.fusion_chunk_px, overlap_px=args.fusion_overlap_px
        ),
        decon_max_iters=args.decon_max_iters,
        round_batch_size=args.round_batch_size,
        num_devices=args.num_gpus,
        registration_diagnostics=args.registration_diagnostics,
        verbose=2 if args.registration_diagnostics else 1,
    )
    if args.global_registration_only:
        reg.global_register()
    else:
        reg.register_all_tiles()


def main(argv=None) -> None:
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    local_register_data(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
