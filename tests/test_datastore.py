"""Datastore contract tests: layout, round-trips, state machine.

Modeled on the reference test strategy (SURVEY.md §4): round-trip
invariants for every array/attribute type the pipeline persists.
"""

import json

import numpy as np
import pandas as pd
import pytest

from merfish3d_tpu.datastore import qi2labDataStore, zarrio


@pytest.fixture()
def store(tmp_path):
    ds = qi2labDataStore(tmp_path / "qi2labdatastore")
    ds.channels_in_data = ["alexa488", "alexa561", "alexa647"]
    ds.num_tiles = 2
    ds.microscope_type = "3D"
    ds.tile_overlap = 0.2
    ds.e_per_ADU = 0.51
    ds.na = 1.35
    ds.ri = 1.51
    ds.binning = 1
    ds.voxel_size_zyx_um = [0.31, 0.098, 0.098]
    ds.experiment_order = np.array(
        [[1, 1, 2], [2, 3, 4], [3, 5, 6], [4, 7, 8]], dtype=np.int64
    )
    cb = pd.DataFrame(
        {
            "gene_id": ["geneA", "geneB", "blank01"],
            **{
                f"bit{i:02d}": np.random.default_rng(i).integers(0, 2, 3)
                for i in range(1, 9)
            },
        }
    )
    ds.codebook = cb
    return ds


def test_layout_created(store):
    root = store.datastore_path
    assert (root / "datastore_state.json").exists()
    assert (root / "calibrations" / "attributes.json").exists()
    for sub in (
        "fiducial",
        "readouts",
        "feature_predictor_localizations",
        "fused",
        "segmentation/cellpose",
        "decoded",
        "all_tiles_filtered_decoded_features",
    ):
        assert (root / sub).is_dir()
    state = json.loads((root / "datastore_state.json").read_text())
    assert state["Version"] == 0.6
    assert state["Initialized"] is True


def test_ids_and_linkers(store):
    assert store.num_rounds == 4
    assert store.num_bits == 8
    assert store.tile_ids == ["tile0000", "tile0001"]
    assert store.round_ids[0] == "round001"
    assert store.bit_ids[-1] == "bit008"
    store.initialize_tile(0)
    assert store.load_local_bit_linker(0, 1) == [3, 4]
    assert store.load_local_round_linker(0, 4) == 3  # bit005 acquired in round 3


def test_reopen_roundtrip(store):
    path = store.datastore_path
    ds2 = qi2labDataStore(path)
    assert ds2.num_rounds == 4
    assert ds2.num_bits == 8
    assert ds2.num_tiles == 2
    np.testing.assert_allclose(ds2.voxel_size_zyx_um, [0.31, 0.098, 0.098])
    assert list(ds2.codebook["gene_id"]) == ["geneA", "geneB", "blank01"]
    assert ds2.codebook.shape == (3, 9)
    assert ds2.experiment_order.shape == (4, 3)


def test_corrected_image_roundtrip(store):
    store.initialize_tile(0)
    img = (np.random.default_rng(0).random((4, 32, 48)) * 4000).astype(np.uint16)
    store.save_local_corrected_image(img, tile=0, round=0, psf_idx=1, gain_correction=True)
    out = store.load_local_corrected_image(tile=0, round=0)
    np.testing.assert_array_equal(out, img)
    # readout side
    store.save_local_corrected_image(img, tile=0, bit=2)
    np.testing.assert_array_equal(store.load_local_corrected_image(tile=0, bit=2), img)
    # future read
    fut = store.load_local_corrected_image(tile=0, round=0, return_future=True)
    np.testing.assert_array_equal(np.asarray(fut.result()), img)


def test_stage_and_wavelengths(store):
    store.initialize_tile(0)
    affine = np.eye(4)
    affine[1, 3] = 5.0
    store.save_local_stage_position_zyx_um([100.0, 2.5, -3.0], tile=0, round=0, affine_zyx_px=affine)
    stage, aff = store.load_local_stage_position_zyx_um(tile=0, round=0)
    np.testing.assert_allclose(stage, [100.0, 2.5, -3.0])
    np.testing.assert_allclose(aff, affine)
    store.save_local_wavelengths_um((0.488, 0.520), tile=0, round=0)
    assert store.load_local_wavelengths_um(tile=0, round=0) == (0.488, 0.520)


def test_round_transform_and_registered(store):
    store.initialize_tile(0)
    xf = np.eye(4)
    xf[:3, 3] = [0.5, -1.0, 2.0]
    store.save_local_round_transform_zyx_um(xf, tile=0, round=1)
    np.testing.assert_allclose(store.load_local_round_transform_zyx_um(tile=0, round=1), xf)
    img = (np.random.default_rng(1).random((3, 16, 16)) * 1000).astype(np.uint16)
    store.save_local_registered_image(img, tile=0, round=1)
    np.testing.assert_array_equal(store.load_local_registered_image(tile=0, round=1), img)
    store.save_local_registered_image(img, tile=0, bit=0)
    np.testing.assert_array_equal(store.load_local_registered_image(tile=0, bit=0), img)


def test_sofima_flow_roundtrip_exact(store):
    """Float32 flow round-trip must be exact (docs/datastore.md:205-209)."""
    store.initialize_tile(0)
    rng = np.random.default_rng(2)
    flow = rng.normal(size=(3, 4, 6, 8)).astype(np.float32)
    store.save_local_sofima_flow_field(
        flow,
        tile=0,
        round=1,
        map_stride_zyx_px=[5.0, 16.0, 16.0],
        map_box_start_xyz_px=[8.0, 8.0, 2.5],
        map_box_size_xyz_px=[112.0, 80.0, 15.0],
        reference_shape_zyx_px=[20, 96, 128],
        moving_shape_zyx_px=[20, 96, 128],
        valid_flow_vectors=120,
    )
    out, attrs = store.load_local_sofima_flow_field(tile=0, round=1)
    np.testing.assert_array_equal(out, flow)
    assert attrs["map_stride_zyx_px"] == [5.0, 16.0, 16.0]
    assert attrs["map_box_start_xyz_px"] == [8.0, 8.0, 2.5]
    assert attrs["reference_shape_zyx_px"] == [20, 96, 128]
    assert attrs["valid_flow_vectors"] == 120


def test_feature_predictor_roundtrip(store):
    store.initialize_tile(0)
    prob = np.random.default_rng(3).random((3, 16, 16)).astype(np.float32)
    store.save_local_feature_predictor_image(prob, tile=0, bit=1, model_name="simfish")
    # probabilities persist as uint8/255 (quarter of f32 on the link and
    # the single-core compressor — see save_local_feature_predictor_image);
    # loads dequantize to exact k/255 float32
    loaded = store.load_local_feature_predictor_image(tile=0, bit=1)
    assert np.asarray(loaded).dtype == np.float32
    np.testing.assert_allclose(np.asarray(loaded), prob, atol=0.5 / 255)
    np.testing.assert_array_equal(
        np.asarray(loaded) * 255.0, np.round(np.asarray(loaded) * 255.0)
    )
    spots = pd.DataFrame({"z": [1.0], "y": [2.0], "x": [3.0], "intensity": [10.0]})
    store.save_local_feature_predictor_spots(spots, tile=0, bit=1)
    pd.testing.assert_frame_equal(store.load_local_feature_predictor_spots(tile=0, bit=1), spots)


def test_global_coords_and_fused(store):
    store.initialize_tile(0)
    affine = np.eye(4)
    affine[2, 3] = 10.0
    store.save_global_coord_xforms_um(
        0, affine_zyx_um=affine, origin_zyx_um=[0, 1, 2], spacing_zyx_um=[0.31, 0.098, 0.098]
    )
    a, o, s = store.load_global_coord_xforms_um(0)
    np.testing.assert_allclose(a, affine)
    np.testing.assert_allclose(o, [0, 1, 2])
    fused = (np.random.default_rng(4).random((4, 32, 32)) * 100).astype(np.uint16)
    store.save_global_fiducial_image(
        fused, affine_zyx_um=affine, origin_zyx_um=[0, 0, 0], spacing_zyx_um=[1, 1, 1]
    )
    img, (a2, o2, s2) = store.load_global_fiducial_image()
    np.testing.assert_array_equal(img, fused)
    np.testing.assert_allclose(a2, affine)


def test_decoded_tables_and_run_keys(store):
    df = pd.DataFrame({"gene_id": ["geneA"], "global_x": [1.0], "global_y": [2.0], "global_z": [3.0]})
    store.save_local_decoded_spots(df, tile=0)
    pd.testing.assert_frame_equal(store.load_local_decoded_spots(tile=0), df)
    store.save_global_filtered_decoded_spots(df)
    pd.testing.assert_frame_equal(store.load_global_filtered_decoded_spots(), df)
    assert (store.datastore_path / "all_tiles_filtered_decoded_features" / "decoded_features.csv.gz").exists()
    # namespaced run
    store.decode_run_key = "expA"
    assert store.load_local_decoded_spots(tile=0) is None
    store.save_local_decoded_spots(df, tile=0)
    assert (store.datastore_path / "decoded" / "expA" / "tile0000_decoded_features.parquet").exists()
    tmp = store.decoded_temporary_dir(0)
    assert tmp.is_dir() and "iteration_000" in str(tmp)


def test_normalization_vectors_and_chromatic(store):
    store.global_normalization_vector = np.arange(8, dtype=np.float32) + 1
    store.global_background_vector = np.zeros(8)
    np.testing.assert_allclose(store.global_normalization_vector, np.arange(8) + 1)
    store.save_decode_normalization_vectors(np.ones(8), np.zeros(8), run_key="r1")
    norm, bg = store.load_decode_normalization_vectors("r1")
    np.testing.assert_allclose(norm, np.ones(8))
    xf = np.eye(4)
    xf[0, 3] = 0.1
    store.save_chromatic_affine_transforms_zyx_um({"0.561": xf})
    np.testing.assert_allclose(
        store.load_chromatic_affine_transform_zyx_um(wavelength_um=0.561), xf
    )
    np.testing.assert_allclose(
        store.load_chromatic_affine_transform_zyx_um(channel_name="0.561"), xf
    )
    # identity fallback for unknown channel
    np.testing.assert_allclose(
        store.load_chromatic_affine_transform_zyx_um(wavelength_um=0.9), np.eye(4)
    )
    # reopen persistence
    ds2 = qi2labDataStore(store.datastore_path)
    np.testing.assert_allclose(
        ds2.load_chromatic_affine_transform_zyx_um(wavelength_um=0.561), xf
    )
    np.testing.assert_allclose(ds2.global_normalization_vector, np.arange(8) + 1)


def test_psfs_ragged(store):
    psfs = [np.random.default_rng(i).random((5 + i, 7, 7)).astype(np.float32) for i in range(3)]
    store.channel_psfs = psfs
    out = store.channel_psfs
    assert len(out) == 3
    for a, b in zip(out, psfs):
        np.testing.assert_allclose(a, b)


def test_ome_metadata_written(store):
    store.initialize_tile(0)
    img = np.zeros((4, 16, 16), dtype=np.uint16)
    store.save_local_corrected_image(img, tile=0, round=0)
    p = store.datastore_path / "fiducial" / "tile0000" / "round001" / "corrected_data.ome.zarr"
    meta = json.loads((p / "zarr.json").read_text())
    ome = meta["attributes"]["ome"]
    assert ome["version"] == "0.5"
    axes = ome["multiscales"][0]["axes"]
    assert [a["name"] for a in axes] == ["z", "y", "x"]
    scale, _ = zarrio.read_ome_transforms(p)
    np.testing.assert_allclose(scale, [0.31, 0.098, 0.098])
    # extra attrs flat beside ome
    assert meta["attributes"]["psf_idx"] == 0


def test_legacy_warpfield_roundtrip(store):
    store.initialize_tile(0)
    flow = np.random.default_rng(9).normal(size=(3, 4, 8, 8)).astype(np.float32)
    store.save_coord_of_xform_px(
        flow, tile=0, round=1, block_size=[8, 16, 16], block_stride=[4, 8, 8]
    )
    arr, bs, bst = store.load_coord_of_xform_px(tile=0, round=1)
    np.testing.assert_array_equal(arr, flow)
    np.testing.assert_allclose(bs, [8, 16, 16])
    np.testing.assert_allclose(bst, [4, 8, 8])


def test_stage_position_updates_ome_translation(tmp_path):
    """The OME multiscales translation tracks the stored stage origin in
    both save orders (reference `qi2labDataStore.py:3358-3360`)."""
    from merfish3d_tpu.datastore import qi2labDataStore, zarrio

    ds = qi2labDataStore(tmp_path / "qi2labdatastore")
    ds.num_tiles = 1
    ds.voxel_size_zyx_um = [0.31, 0.098, 0.098]
    ds.experiment_order = np.array([[1, 1, 2]])
    ds.initialize_tile(0)
    img = np.zeros((2, 4, 4), np.uint16)

    # image first, then stage → update-in-place path
    ds.save_local_corrected_image(img, tile=0, round=0)
    ds.save_local_stage_position_zyx_um([1.0, 20.0, 30.0], tile=0, round=0)
    _, translation = zarrio.read_ome_transforms(
        tmp_path / "qi2labdatastore" / "fiducial" / "tile0000" / "round001"
        / "corrected_data.ome.zarr"
    )
    assert translation == [1.0, 20.0, 30.0]

    # stage first, then image → translation picked up at write time
    ds.save_local_stage_position_zyx_um([2.0, 5.0, -7.0], tile=0, bit=0)
    ds.save_local_corrected_image(img, tile=0, bit=0)
    _, translation = zarrio.read_ome_transforms(
        tmp_path / "qi2labdatastore" / "readouts" / "tile0000" / "bit001"
        / "corrected_data.ome.zarr"
    )
    assert translation == [2.0, 5.0, -7.0]


# --------------------------------------------- open-time full validation
def _mini_corrected_store(tmp_path):
    """A 1-tile store marked Corrected with complete attrs + images."""
    ds = qi2labDataStore(tmp_path / "qi2labdatastore")
    ds.channels_in_data = ["fiducial", "readout1"]
    ds.num_tiles = 1
    ds.microscope_type = "3D"
    ds.tile_overlap = 0.2
    ds.e_per_ADU = 1.0
    ds.na = 1.35
    ds.ri = 1.4
    ds.binning = 1
    ds.voxel_size_zyx_um = [0.31, 0.098, 0.098]
    ds.experiment_order = np.array([[1, 1, 2]], dtype=np.int64)
    ds.codebook = pd.DataFrame(
        {"gene_id": ["geneA", "geneB"], "bit01": [1, 0], "bit02": [0, 1]}
    )
    ds.initialize_tile(0)
    img = np.ones((4, 16, 16), np.uint16)
    ds.save_local_corrected_image(img, tile=0, round=0, psf_idx=0)
    ds.save_local_stage_position_zyx_um([0, 0, 0], tile=0, round=0)
    ds.save_local_wavelengths_um((0.488, 0.520), tile=0, round=0)
    for b in (0, 1):
        ds.save_local_corrected_image(img, tile=0, bit=b, psf_idx=1)
        ds.save_local_wavelengths_um((0.561, 0.590), tile=0, bit=b)
    state = ds.datastore_state
    state.update({"Corrected": True})
    ds.datastore_state = state
    return ds


def test_parse_validates_corrected_store(tmp_path):
    ds = _mini_corrected_store(tmp_path)
    # clean reopen passes full validation
    qi2labDataStore(ds.datastore_path)


def test_parse_detects_truncated_zarr(tmp_path):
    """Reference `_parse_datastore` re-validates arrays on open
    (`qi2labDataStore.py:2423-2845`); a zarr with metadata but no chunk
    data must fail at open time, not mid-stage."""
    import shutil

    ds = _mini_corrected_store(tmp_path)
    chunk_dir = (
        ds.datastore_path / "fiducial" / "tile0000" / "round001"
        / "corrected_data.ome.zarr" / "0" / "c"
    )
    shutil.rmtree(chunk_dir)
    with pytest.raises(ValueError, match="no chunk data"):
        qi2labDataStore(ds.datastore_path)
    # escape hatch still opens
    qi2labDataStore(ds.datastore_path, validate=False)


def test_parse_detects_corrupt_metadata(tmp_path):
    ds = _mini_corrected_store(tmp_path)
    meta = (
        ds.datastore_path / "readouts" / "tile0000" / "bit001"
        / "corrected_data.ome.zarr" / "0" / "zarr.json"
    )
    meta.write_text("{not json")
    with pytest.raises(ValueError, match="corrupt zarr metadata"):
        qi2labDataStore(ds.datastore_path)


def test_parse_detects_missing_attribute(tmp_path):
    ds = _mini_corrected_store(tmp_path)
    attrs_path = (
        ds.datastore_path / "fiducial" / "tile0000" / "round001"
        / "attributes.json"
    )
    attrs = json.loads(attrs_path.read_text())
    del attrs["stage_zyx_um"]
    attrs_path.write_text(json.dumps(attrs))
    with pytest.raises(KeyError, match="stage_zyx_um"):
        qi2labDataStore(ds.datastore_path)


def test_parse_detects_missing_decoded_parquet(tmp_path):
    ds = _mini_corrected_store(tmp_path)
    state = ds.datastore_state
    state.update({"DecodedSpots": True})
    ds.datastore_state = state
    with pytest.raises(FileNotFoundError, match="decoded spots missing"):
        qi2labDataStore(ds.datastore_path)


def test_keyed_decode_reopens_with_validation(store):
    """Decode outputs written under a decode_run_key must satisfy
    open-time validation (review r3: the DecodedSpots/FilteredSpots
    checks looked only at the root layout, making a keyed store
    unopenable with validate=True)."""
    df = pd.DataFrame(
        {"gene_id": ["geneA"], "global_x": [1.0], "global_y": [2.0],
         "global_z": [3.0]}
    )
    store.decode_run_key = "runA"
    for t in range(store.num_tiles):
        store.save_local_decoded_spots(df, tile=t)
    store.save_global_filtered_decoded_spots(df)
    state = store.datastore_state
    state.update({"DecodedSpots": True, "FilteredSpots": True})
    store.datastore_state = state
    reopened = qi2labDataStore(store.datastore_path)  # validate=True
    assert reopened.datastore_state["FilteredSpots"] is True


def test_state_write_is_atomic(store):
    """datastore_state.json is written via temp+rename; no .tmp residue
    and the file parses after every write."""
    import json

    state = store.datastore_state
    state.update({"Calibrated": True})
    store.datastore_state = state
    root = store.datastore_path
    assert not (root / "datastore_state.json.tmp").exists()
    with (root / "datastore_state.json").open() as fh:
        assert json.load(fh)["Calibrated"] is True
