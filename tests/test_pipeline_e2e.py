"""End-to-end simulation regression: synthetic experiment → decode → F1.

The analog of the reference E2E matrix
(`tests/test_simulation_example_pipeline.py`): generate a hermetic
synthetic MERFISH experiment, run the full decode pipeline (normalization
seeding + iterative optimization + decode + blank-fraction filter), and
pin the F1 score.
"""

import numpy as np
import pandas as pd
import pytest

from merfish3d_tpu.cli.simulation.calculate_f1 import match_spots_f1
from merfish3d_tpu.pipeline import PixelDecoder
from merfish3d_tpu.utils.simulation import generate_synthetic_experiment


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    path = tmp_path_factory.mktemp("sim") / "qi2labdatastore"
    ds, gt = generate_synthetic_experiment(
        path, shape=(10, 96, 96), n_spots=80, seed=7
    )
    return ds, gt


def test_decode_one_tile_produces_barcodes(experiment):
    ds, gt = experiment
    decoder = PixelDecoder(
        ds,
        minimum_pixels=4,
        magnitude_threshold=(0.9, 10.0),
        verbose=0,
    )
    decoder._load_global_normalization_vectors(recalculate=True)
    df = decoder.decode_one_tile(0, save=True)
    assert not df.empty
    # schema: all reference columns present
    for col in (
        "area", "z", "y", "x", "tile_z", "tile_y", "tile_x",
        "global_z", "global_y", "global_x", "gene_id", "barcode_id",
        "tile_idx", "on_bit_1", "on_bit_4", "bit01_mean_intensity",
        "bit16_mean_intensity", "signal_mean", "bkd_mean", "s-b_mean",
        "distance_min", "magnitude_mean", "inertia_tensor_eigvals-0",
        "inertia_tensor_eigvals-2",
    ):
        assert col in df.columns, col
    # persisted
    saved = ds.load_local_decoded_spots(0)
    assert len(saved) == len(df)


def test_e2e_f1(experiment):
    ds, gt = experiment
    decoder = PixelDecoder(
        ds,
        minimum_pixels=4,
        magnitude_threshold=(0.9, 10.0),
        verbose=0,
    )
    decoder.optimize_normalization_by_decoding(
        n_random_tiles=1, n_iterations=2
    )
    df = decoder.decode_all_tiles(filter_method="blank_fraction")
    assert not df.empty
    result = match_spots_f1(df, gt, radius_um=1.0)
    # regression pin: the synthetic config must decode nearly perfectly
    assert result["f1"] >= 0.9, result


def test_decode_2d_mode(experiment):
    """2D mode: per-plane labeling + cross-plane dedup
    (reference 2D decode path, `PixelDecoder.py:2515-2541,3755-3939`)."""
    ds, gt = experiment
    decoder = PixelDecoder(
        ds,
        is_3D=False,
        minimum_pixels=3,
        magnitude_threshold=(0.7, 10.0),
        verbose=0,
        decode_run_key="mode2d",
    )
    decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=2)
    df = decoder.decode_all_tiles(filter_method="none")
    assert not df.empty
    result = match_spots_f1(df, gt, radius_um=1.0)
    assert result["f1"] >= 0.7, result


def test_optimize_filtering_refilters(experiment):
    """optimize_filtering re-filters stored decodes without re-decoding
    (reference `optimize_filtering:4506-4584`)."""
    ds, gt = experiment
    decoder = PixelDecoder(
        ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
    )
    # per-tile decodes already persisted by earlier tests in this module
    df = decoder.optimize_filtering(filter_method="blank_fraction")
    assert df is not None
    saved = ds.load_global_filtered_decoded_spots()
    assert len(saved) == len(df)


def test_multi_tile_decode_with_overlap_dedup(tmp_path_factory):
    """Two tiles sharing ground truth in the overlap: the pipeline must
    stitch, decode both, and de-duplicate transcripts in the overlap."""
    path = tmp_path_factory.mktemp("sim2") / "qi2labdatastore"
    ds, gt = generate_synthetic_experiment(
        path,
        shape=(8, 64, 96),
        n_spots=50,
        seed=21,
        n_tiles=2,
        tile_offset_px=(0.0, 0.0, 64.0),  # 32 px x-overlap
    )
    from merfish3d_tpu.pipeline.stitching import global_register

    # rounds already have identity transforms; register tiles globally
    global_register(ds, verbose=0)
    decoder = PixelDecoder(
        ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
    )
    decoder.optimize_normalization_by_decoding(n_random_tiles=2, n_iterations=1)
    df = decoder.decode_all_tiles(filter_method="blank_fraction")
    assert not df.empty
    assert set(df["tile_idx"].unique()) == {0, 1}
    result = match_spots_f1(df, gt, radius_um=1.0)
    assert result["f1"] >= 0.8, result


def test_use_mask_restricts_decode_to_cells(tmp_path_factory):
    """use_mask=True must drop transcripts outside the stored segmentation
    mask (the reference declares the flag but leaves `_load_mask` a TODO,
    `PixelDecoder.py:526-529`; here it is implemented)."""
    path = tmp_path_factory.mktemp("simmask") / "qi2labdatastore"
    ds, gt = generate_synthetic_experiment(
        path, shape=(8, 64, 96), n_spots=60, seed=11
    )
    spacing = np.asarray(ds.voxel_size_zyx_um, np.float64)
    nz, ny, nx = 8, 64, 96
    # identity fused geometry: fused px == tile px
    ds.save_global_fiducial_image(
        np.zeros((nz, ny, nx), np.uint16),
        affine_zyx_um=np.eye(4),
        origin_zyx_um=[0.0, 0.0, 0.0],
        spacing_zyx_um=list(spacing),
    )
    # left half of x is "inside cells"
    mask = np.zeros((ny, nx), np.uint16)
    mask[:, : nx // 2] = 1
    ds.save_global_cellpose_segmentation_image(mask, downsampling=(1.0, 1.0, 1.0))

    kwargs = dict(minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0)
    unmasked = PixelDecoder(ds, **kwargs)
    unmasked._load_global_normalization_vectors(recalculate=True)
    df_all = unmasked.decode_one_tile(0, save=False)
    assert (df_all["tile_x"] >= nx // 2).any(), "need spots on both sides"

    masked = PixelDecoder(ds, use_mask=True, **kwargs)
    df_masked = masked.decode_one_tile(0, save=False)
    assert not df_masked.empty
    # component centroids can straddle the boundary by < 1 spot radius
    assert (df_masked["tile_x"] < nx // 2 + 3).all()
    assert len(df_masked) < len(df_all)


def test_use_mask_requires_segmentation(experiment):
    ds, _ = experiment
    with pytest.raises(ValueError, match="use_mask"):
        PixelDecoder(ds, use_mask=True, verbose=0)


def test_optimization_iteration_checkpoints_resume(experiment, monkeypatch):
    """Each optimization iteration checkpoints its decoded tables to
    `temporary/iteration_NNN/` (reference `qi2labDataStore.py:1117`,
    `PixelDecoder.py:4241-4251`); a resumed run replays from the
    checkpoints without re-decoding and lands on identical vectors."""
    ds, _ = experiment
    dec = PixelDecoder(
        ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
        decode_run_key="ckpt",
    )
    dec.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=2)
    root = ds._decoded_path / "ckpt" / "temporary"
    for it in range(2):
        d = root / f"iteration_{it:03d}"
        assert (d / "complete.json").exists()
        assert (d / "tile0000_decoded_features.parquet").exists()
    norm1 = ds.load_decode_normalization_vectors(run_key="iterative")

    dec2 = PixelDecoder(
        ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
        decode_run_key="ckpt",
    )

    def _no_decode(*args, **kwargs):
        raise AssertionError("resume must not re-decode checkpointed tiles")

    monkeypatch.setattr(dec2, "decode_one_tile", _no_decode)
    dec2.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=2)
    norm2 = ds.load_decode_normalization_vectors(run_key="iterative")
    np.testing.assert_allclose(norm1[0], norm2[0])
    np.testing.assert_allclose(norm1[1], norm2[1])
