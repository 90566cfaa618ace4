"""Full CLI pipeline E2E: the analog of the reference simulation
matrix harness (`tests/test_simulation_example_pipeline.py`), exercising
the real pipeline through the CLI surface: sim-convert --generate →
sim-datastore → sim-preprocess (RLGC decon + registration + prediction) →
sim-decode → F1, plus segmentation and the static viewer export."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from merfish3d_tpu.cli.simulation import (
    convert_simulation_to_experiment as sim_convert,
)
from merfish3d_tpu.cli.simulation import convert_to_datastore as sim_datastore
from merfish3d_tpu.cli.simulation.calculate_f1 import match_spots_f1
from merfish3d_tpu.cli.simulation.pixeldecode import decode_pixels
from merfish3d_tpu.datastore import qi2labDataStore
from merfish3d_tpu.pipeline.registration import DataRegistration


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_e2e")
    raw = root / "raw"
    sim_convert.write_raw_experiment(
        raw, shape=(10, 96, 96), n_spots=60, n_genes=20, n_blanks=4, seed=11
    )
    ds = sim_datastore.convert_data(raw, root)
    return root, raw, ds


def test_raw_layout(workspace):
    root, raw, ds = workspace
    assert (raw / "codebook.csv").exists()
    assert (raw / "exp_order.csv").exists()
    assert (raw / "GT_spots.csv").exists()
    assert (raw / "tile0000" / "bit001.npy").exists()
    assert ds.num_bits == 16
    assert ds.num_rounds == 8
    assert ds.datastore_state["Corrected"] is True


def test_full_pipeline_f1(workspace):
    import time

    root, raw, ds = workspace
    records = {}
    t0 = time.perf_counter()
    reg = DataRegistration(
        ds,
        decon_fiducial=False,  # rounds are identical copies in this sim
        decon_readout=True,
        decon_max_iters=12,
        global_registration=True,
        verbose=0,
    )
    reg.register_all_tiles()
    assert ds.datastore_state["LocalRegistered"] is True
    assert ds.datastore_state["Fused"] is True
    # registration should find ~zero shift between identical-noise rounds
    xf = ds.load_local_round_transform_zyx_um(0, 1)
    spacing = np.asarray(ds.voxel_size_zyx_um)
    assert np.all(np.abs(xf[:3, 3] / spacing) < 1.0)

    records["preprocess_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    df = decode_pixels(
        ds.datastore_path,
        minimum_pixels=4,
        magnitude_threshold=(0.9, 10.0),
        num_tiles=1,
        num_iterations=2,
    )
    records["decode_seconds"] = time.perf_counter() - t0
    gt = pd.read_csv(raw / "GT_spots.csv")
    result = match_spots_f1(df, gt, radius_um=1.0)
    assert result["f1"] >= 0.85, result

    # performance records, the reference harness contract
    # (`tests/test_simulation_example_pipeline.py:480-533,935-948`)
    records["f1"] = result["f1"]
    records["true_positives_per_second"] = (
        result["true_positives"] / records["decode_seconds"]
    )
    records["decoded_spots_per_decode_second"] = (
        result["n_decoded"] / records["decode_seconds"]
    )
    perf_dir = Path(__file__).parent / "data"
    perf_dir.mkdir(exist_ok=True)
    (perf_dir / "simulation_performance.json").write_text(
        json.dumps(records, indent=2)
    )

    # segmentation + assignment on the fused output
    from merfish3d_tpu.pipeline.segmentation import segment_fiducial

    outlines = segment_fiducial(ds, verbose=0)
    assert ds.datastore_state["SegmentedCells"] is True

    # static viewer export works
    from merfish3d_tpu.viz.viewer import (
        component_summary,
        decoded_available,
        export_overview,
        global_fused_available,
    )

    summary = component_summary(ds)
    assert summary["SegmentedCells"] is True
    assert decoded_available(ds) is True
    assert global_fused_available(ds) is True
    png = root / "overview.png"
    export_overview(ds, png)
    assert png.exists() and png.stat().st_size > 1000


def test_cli_parsers_smoke():
    """Every CLI entry point parses its surface without executing."""
    from merfish3d_tpu.cli.qi2lab import (
        bulkseq_correlation,
        chromatic_calibration,
        create_datastore,
        fuseall,
        pixeldecode,
        preprocess,
        segment_fiducial,
        viewer,
    )
    from merfish3d_tpu.cli.simulation import (
        build_figure,
        calculate_f1,
        pixeldecode as sim_pixeldecode,
        register_and_deconvolve,
        sweep_f1,
    )

    assert preprocess.build_parser().parse_args(
        ["--datastore-path", "/tmp/x", "--deformable-registration"]
    ).deformable_registration
    args = pixeldecode.build_parser().parse_args(
        ["--datastore-path", "/tmp/x", "--magnitude-threshold", "0.9", "10"]
    )
    assert args.magnitude_threshold == [0.9, 10]
    for mod in (
        bulkseq_correlation, chromatic_calibration, create_datastore,
        fuseall, segment_fiducial, viewer, build_figure, calculate_f1,
        sim_pixeldecode, register_and_deconvolve, sweep_f1,
    ):
        assert hasattr(mod, "main")


def test_nyquist_defaults(workspace):
    from merfish3d_tpu.cli.qi2lab.pixeldecode import (
        default_magnitude_threshold,
        default_minimum_pixels,
    )

    _, _, ds = workspace
    assert default_minimum_pixels(ds) == 16  # 3D
    assert default_magnitude_threshold(ds) == (1.5, 10.0)


def test_chromatic_injection_recovery(tmp_path_factory):
    """Synthetic chromatic aberration injected at datastore conversion
    (reference `convert_to_datastore.py:42-183`) must be recovered by the
    decode-time RNA-derived chromatic estimator."""
    root = tmp_path_factory.mktemp("chromatic")
    raw = root / "raw"
    sim_convert.write_raw_experiment(
        raw, shape=(10, 128, 128), n_spots=120, n_genes=20, n_blanks=4, seed=3
    )
    injection = sim_datastore.make_injection_affine(
        z_shift_um=0.15, yx_scale=1.0, y_shift_um=0.3, x_shift_um=-0.25
    )
    ds = sim_datastore.convert_data(
        raw, root, inject_chromatic_aberration=True,
        injection_affine=injection,
    )
    # identity registration: copy corrected → decon, unit probability
    for b in range(ds.num_bits):
        img = ds.load_local_corrected_image(tile=0, bit=b)
        ds.save_local_registered_image(img, tile=0, bit=b)
        ds.save_local_feature_predictor_image(
            np.ones(np.asarray(img).shape, np.float32), tile=0, bit=b
        )
    for r in range(ds.num_rounds):
        img = ds.load_local_corrected_image(tile=0, round=r)
        ds.save_local_registered_image(img, tile=0, round=r)
        ds.save_local_round_transform_zyx_um(np.eye(4), tile=0, round=r)

    from merfish3d_tpu.pipeline.decoder import PixelDecoder

    decoder = PixelDecoder(
        ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
        estimate_chromatic_affines=True,
    )
    decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=3)
    calibration = ds.load_chromatic_affine_transforms_zyx_um()
    channels = calibration.get("channels", {})
    non_ref = [c for c in channels.values() if not c.get("reference_channel")]
    assert non_ref, channels
    est = np.asarray(non_ref[0]["affine_zyx_um"])
    assert non_ref[0]["status"] in ("affine_estimated", "identity_initialization")
    if non_ref[0]["status"] == "affine_estimated":
        np.testing.assert_allclose(est[:3, 3], injection[:3, 3], atol=0.12)

    # decode with the estimated correction: F1 should be high
    df = decoder.decode_all_tiles(filter_method="blank_fraction")
    gt = pd.read_csv(raw / "GT_spots.csv")
    result = match_spots_f1(df, gt, radius_um=1.0)
    assert result["f1"] >= 0.8, result


def test_cli_subprocess_entry_points(tmp_path):
    """The CLI modules run as scripts (python -m ...) end to end on a tiny
    dataset: convert → datastore → f1score."""
    import subprocess
    import sys

    env = dict(__import__("os").environ)
    env["JAX_PLATFORMS"] = "cpu"

    def run(args):
        proc = subprocess.run(
            [sys.executable, "-m"] + args, capture_output=True, text=True,
            env=env, cwd=str(Path(__file__).parent.parent), timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc

    raw = tmp_path / "raw"
    run([
        "merfish3d_tpu.cli.simulation.convert_simulation_to_experiment",
        "--generate", "--output-dir", str(raw),
        "--shape-zyx", "6", "48", "48", "--n-spots", "20",
    ])
    assert (raw / "GT_spots.csv").exists()
    run([
        "merfish3d_tpu.cli.simulation.convert_to_datastore",
        "--input-dir", str(raw), "--output-dir", str(tmp_path),
    ])
    assert (tmp_path / "qi2labdatastore" / "datastore_state.json").exists()
    proc = run([
        "merfish3d_tpu.cli.simulation.calculate_f1",
        "--decoded", str(raw / "GT_spots.csv"),
        "--ground-truth", str(raw / "GT_spots.csv"),
    ])
    result = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert result["f1"] == 1.0  # GT vs itself


def test_sweep_f1_single_point(workspace):
    """sim-sweep runs a decode-parameter grid point and scores it."""
    from merfish3d_tpu.cli.simulation.sweep_f1 import sweep

    root, raw, ds = workspace
    result = sweep(
        ds.datastore_path,
        raw / "GT_spots.csv",
        magnitude_lows=(0.9,),
        minimum_pixels_grid=(4,),
        output_csv=root / "sweep.csv",
        results_json=root / "decode_params_results.json",
        verbose=0,
    )
    assert len(result) == 1
    assert 0.0 <= result["f1"].iloc[0] <= 1.0
    assert (root / "sweep.csv").exists()
    # incremental per-point JSON checkpoint (reference sweep_f1.py:380-382)
    points = json.loads((root / "decode_params_results.json").read_text())
    assert len(points) == 1
    (entry,) = points.values()
    assert "f1" in entry


def test_build_matrix_figure(workspace, tmp_path):
    """The multi-case comparison figure renders GT vs decoded overlays
    (reference build_figure.py:179-438)."""
    from merfish3d_tpu.cli.simulation.build_figure import build_matrix_figure

    root, raw, ds = workspace
    case = tmp_path / "case"
    case.mkdir()
    (case / "raw").symlink_to(raw)
    (case / "qi2labdatastore").symlink_to(ds.datastore_path)
    png = tmp_path / "matrix.png"
    build_matrix_figure([case], png, labels=["0.315 um"])
    assert png.exists() and png.stat().st_size > 5000


def test_decode_tiles_worker_functional(workspace):
    """The device-pinned worker decodes its tile subset end-to-end and
    persists per-tile spots (reference `PixelDecoder.decode_tiles_worker:
    208-305` — one worker per GPU; here one thread per device)."""
    from merfish3d_tpu.pipeline.decoder import decode_tiles_worker

    root, raw, ds = workspace
    if not ds.datastore_state.get("LocalRegistered"):
        DataRegistration(
            ds,
            decon_fiducial=False,
            decon_readout=True,
            decon_max_iters=12,
            global_registration=True,
            verbose=0,
        ).register_all_tiles()

    # wipe any existing per-tile decode so the worker's write is observable
    out = ds.datastore_path / "decoded" / "tile0000_decoded_features.parquet"
    if out.exists():
        out.unlink()

    decode_tiles_worker(
        ds.datastore_path,
        [0],
        gpu_id=0,
        merfish_bits=16,
        decode_mode="3d",
        lowpass_sigma=(1.0, 0.7, 0.7),
        magnitude_threshold=(0.9, 10.0),
        minimum_pixels=4,
        normalization_method="none",
    )
    df = qi2labDataStore(ds.datastore_path, validate=False).load_local_decoded_spots(0)
    assert df is not None and len(df) > 0
    assert {"gene_id", "z", "y", "x"}.issubset(df.columns)
