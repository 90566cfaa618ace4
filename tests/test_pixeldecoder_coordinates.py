"""Pure unit test of the pixel→global coordinate chain (mirrors reference
`tests/test_pixeldecoder_coordinates.py:6`): the camera-to-stage affine is
applied BEFORE the global affine."""

import numpy as np

from merfish3d_tpu.pipeline.decoder import PixelDecoder


def test_warp_pixel_applies_camera_affine_before_global():
    decoder = PixelDecoder.__new__(PixelDecoder)
    spacing = np.array([0.31, 0.098, 0.098])
    origin = np.array([10.0, 20.0, 30.0])
    camera = np.eye(4)
    camera[1, 1] = -1.0  # y-flip camera orientation
    camera[1, 3] = 5.0
    global_affine = np.eye(4)
    global_affine[:3, 3] = [1.0, 2.0, 3.0]
    state = {
        "z_crop_offset": 0,
        "spacing": spacing,
        "origin": origin,
        "affine": global_affine,
        "camera_to_stage_affine": camera,
    }
    pts = np.array([[2.0, 4.0, 6.0]])
    out = decoder._warp_pixels(pts, state)

    physical = pts[0] * spacing + origin
    staged = (camera @ np.append(physical, 1.0))[:3]
    expected = (global_affine @ np.append(staged, 1.0))[:3]
    np.testing.assert_allclose(out[0], expected, rtol=1e-12)

    # the wrong order (global before camera) must NOT match
    wrong = (camera @ np.append((global_affine @ np.append(physical, 1.0))[:3], 1.0))[:3]
    assert not np.allclose(out[0], wrong)


def test_device_resident_stack_decode_matches_host(tmp_path, monkeypatch):
    """Decoding from a device-resident warped stack (the zero-readback
    path, forced here via MERFISH3D_DECODE_DEVICE_STACK=1) must produce a
    table identical to the host-stack path."""
    import pandas as pd

    from merfish3d_tpu.utils.simulation import generate_synthetic_experiment

    ds, _gt = generate_synthetic_experiment(
        tmp_path / "qi2labdatastore", shape=(8, 64, 64), n_spots=40, seed=7
    )

    def decode(mode, run_key):
        monkeypatch.setenv("MERFISH3D_DECODE_DEVICE_STACK", mode)
        d = PixelDecoder(
            ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0),
            verbose=0, decode_run_key=run_key,
        )
        d._global_normalization_vector = np.full(16, 400.0, np.float32)
        d._global_background_vector = np.full(16, 40.0, np.float32)
        return d.decode_one_tile(0, save=False)

    df_host = decode("0", "host")
    df_dev = decode("1", "dev")
    assert len(df_host) > 0
    pd.testing.assert_frame_equal(
        df_host.reset_index(drop=True), df_dev.reset_index(drop=True)
    )
