"""Tests for shading estimation, darkfield/dehaze, dataio, PSFs, and bead
chromatic calibration."""

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp

from merfish3d_tpu.models.psf import born_wolf_psf, gaussian_psf, make_channel_psfs
from merfish3d_tpu.ops.darkfield import dark_sectioning, dehaze_fast2, guided_filter
from merfish3d_tpu.utils.chromatic_calibration import (
    detect_beads,
    estimate_chromatic_affines,
    fit_affine_source_to_reference,
    mutual_nearest_neighbors,
)
from merfish3d_tpu.utils.dataio import cell_by_gene_counts, write_sparse_mtx
from merfish3d_tpu.utils.imageprocessing import (
    apply_shading_correction,
    estimate_shading,
)


def test_estimate_shading_recovers_vignette():
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 128), np.linspace(-1, 1, 128), indexing="ij")
    true_field = 1.0 - 0.4 * (yy**2 + xx**2)
    imgs = np.stack(
        [true_field * rng.uniform(80, 120) + rng.normal(0, 2, (128, 128)) for _ in range(8)]
    ).astype(np.float32)
    field = estimate_shading(imgs, smooth_sigma=16.0)
    # shape of the vignette recovered: corners darker than center
    assert field[64, 64] > field[5, 5] * 1.2
    corrected = apply_shading_correction(imgs[0], field)
    cv_before = imgs[0].std() / imgs[0].mean()
    cv_after = corrected.std() / corrected.mean()
    assert cv_after < 0.5 * cv_before


def test_guided_filter_smooths_preserving_edges():
    rng = np.random.default_rng(1)
    img = np.zeros((64, 64), np.float32)
    img[:, 32:] = 1.0  # guided-filter eps convention assumes ~[0,1] range
    noisy = img + rng.normal(0, 0.05, img.shape).astype(np.float32)
    out = np.asarray(
        guided_filter(jnp.asarray(noisy), jnp.asarray(noisy), radius=8, eps=1e-2)
    )
    # noise suppressed within flat regions
    assert out[:, :24].std() < noisy[:, :24].std() * 0.5
    # edge preserved
    assert out[:, 40:].mean() - out[:, :24].mean() > 0.8


def test_dehaze_removes_haze_floor():
    rng = np.random.default_rng(2)
    spots = np.zeros((96, 96), np.float32)
    for _ in range(15):
        y, x = rng.integers(10, 86, 2)
        spots[y, x] = 500.0
    import scipy.ndimage

    img = scipy.ndimage.gaussian_filter(spots, 1.5) + 50.0  # haze floor
    out = np.asarray(dehaze_fast2(jnp.asarray(img)))
    # dark-channel prior: haze floor reduced toward the atmosphere and
    # peak-to-background contrast strongly amplified (the prior divides
    # in-focus signal by the ~0.1 transmission floor, reference
    # `darkfield.py:362-383`)
    assert np.median(out) < np.median(img)
    contrast_in = img.max() / np.median(img)
    contrast_out = out.max() / max(np.median(out), 1e-6)
    assert contrast_out > 3.0 * contrast_in
    vol = dark_sectioning(np.stack([img, img]))
    assert vol.shape == (2, 96, 96)
    assert vol.dtype == np.uint16
    # recombined hi + dehazed-lo: spots dominate the rescaled output
    assert np.median(vol) < 0.2 * 65535


def test_darkfield_reference_helpers():
    from merfish3d_tpu.ops.darkfield import (
        confirm_block,
        get_atmosphere,
        get_dark_channel,
        hpgauss,
        lpgauss,
        psf_generator,
        separate_hi_lo,
        window_sum_filter,
    )

    # windowed sum == box mean * window area (interior exact)
    rng = np.random.default_rng(5)
    img = rng.random((32, 32)).astype(np.float32)
    s = np.asarray(window_sum_filter(jnp.asarray(img), 3))
    ref = 0.0
    ref = img[5 - 3 : 5 + 4, 9 - 3 : 9 + 4].sum()
    assert s[5, 9] == pytest.approx(ref, rel=1e-5)

    # lp + hp = 1 everywhere; DC gain of lp is 1
    lp = lpgauss(24, 24, 4.0)
    hp = hpgauss(24, 24, 4.0)
    np.testing.assert_allclose(lp + hp, 1.0, atol=1e-6)
    assert lp[0, 0] == pytest.approx(1.0)

    # Airy PSF: normalized, peak at the fftshifted center
    psf = psf_generator(0.58, 0.098, 1.35, 64, 1.0)
    assert psf.sum() == pytest.approx(1.0, rel=1e-4)
    assert psf[32, 32] == psf.max()

    # band split reconstructs: hi + lo == image filtered by (hp+lp)=1
    params = {
        "Nx": 64, "Ny": 64, "NA": 1.35,
        "emwavelength": 0.58, "pixelsize": 0.098, "factor": 1.0,
    }
    plane = rng.random((64, 64)).astype(np.float32)
    hi, lo, lp_f, el = separate_hi_lo(plane, params, deg=10.0, divide=0.5)
    np.testing.assert_allclose(
        np.asarray(hi) + np.asarray(lo), plane, atol=1e-4
    )
    block = confirm_block(params, lp_f)
    assert 0 < block <= 64

    # dark channel = local min; atmosphere from brightest dark pixels
    dc = np.asarray(get_dark_channel(jnp.asarray(plane), 5))
    assert (dc <= plane + 1e-6).all()
    atm = float(get_atmosphere(jnp.asarray(plane), jnp.asarray(dc)))
    assert 0.0 < atm <= float(plane.max())


def test_psf_models():
    psf_g = gaussian_psf(
        emission_wavelength_um=0.59, na=1.35, ri=1.4,
        voxel_size_zyx_um=(0.31, 0.098, 0.098), shape_zyx=(15, 15, 15),
    )
    np.testing.assert_allclose(psf_g.sum(), 1.0, rtol=1e-5)
    assert psf_g[7, 7, 7] == psf_g.max()
    psf_bw = born_wolf_psf(
        emission_wavelength_um=0.59, na=1.35, ri=1.4,
        voxel_size_zyx_um=(0.31, 0.098, 0.098), shape_zyx=(15, 15, 15),
    )
    np.testing.assert_allclose(psf_bw.sum(), 1.0, rtol=1e-5)
    assert psf_bw[7, 7, 7] == psf_bw.max()
    psfs = make_channel_psfs(
        [0.52, 0.59, 0.67], na=1.35, ri=1.4, voxel_size_zyx_um=(0.31, 0.098, 0.098)
    )
    assert len(psfs) == 3


def test_bead_chromatic_calibration_recovers_affine():
    rng = np.random.default_rng(3)
    shape = (16, 96, 96)
    spacing = np.array([0.31, 0.098, 0.098])
    true_affine = np.eye(4)
    true_affine[1, 3] = 0.3   # y shift µm
    true_affine[2, 3] = -0.2  # x shift µm
    beads_um = np.column_stack(
        [
            rng.uniform(2, 14, 40) * spacing[0],
            rng.uniform(10, 86, 40) * spacing[1],
            rng.uniform(10, 86, 40) * spacing[2],
        ]
    )

    def render(points_um):
        vol = np.zeros(shape, np.float32)
        zz, yy, xx = np.meshgrid(
            *[np.arange(s, dtype=np.float64) for s in shape], indexing="ij"
        )
        for p in points_um:
            c = p / spacing
            vol += (
                800
                * np.exp(
                    -((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
                    / (2 * 1.2**2)
                )
            ).astype(np.float32)
        return vol + rng.normal(0, 1, shape).astype(np.float32)

    ref_vol = render(beads_um)
    # channel 2 beads appear displaced: applying true_affine to channel-2
    # coords maps back to reference coords → channel-2 positions = inv(A) @ ref
    inv = np.linalg.inv(true_affine)
    homo = np.concatenate([beads_um, np.ones((len(beads_um), 1))], axis=1)
    ch2_um = (homo @ inv.T)[:, :3]
    ch2_vol = render(ch2_um)

    calibration = estimate_chromatic_affines(
        [ref_vol, ch2_vol], [0.52, 0.67], voxel_size_zyx_um=spacing
    )
    ch = calibration["channels"]["wavelength_0.670000"]
    assert ch["status"] == "affine_estimated"
    est = np.asarray(ch["affine_zyx_um"])
    np.testing.assert_allclose(est[:3, 3], true_affine[:3, 3], atol=0.08)


def test_mutual_nn_and_fit():
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 100, (50, 3))
    tgt = src + [0.5, -0.3, 0.2]
    s, t = mutual_nearest_neighbors(src, tgt, max_distance=2.0)
    assert len(s) == 50
    affine, diag = fit_affine_source_to_reference(s, t)
    np.testing.assert_allclose(affine[:3, 3], [0.5, -0.3, 0.2], atol=1e-6)
    assert diag["n_inliers"] == 50


def test_cell_by_gene_and_mtx(tmp_path):
    df = pd.DataFrame(
        {
            "gene_id": ["g1", "g1", "g2", "blank01", "g2"],
            "cell_id": [0, 0, 0, 1, -1],
        }
    )
    counts = cell_by_gene_counts(df)
    assert counts.loc[0, "g1"] == 2
    assert counts.loc[0, "g2"] == 1
    assert "blank01" not in counts.columns
    out = write_sparse_mtx(counts, tmp_path / "mtx")
    assert (out / "matrix.mtx").exists()
    assert (out / "barcodes.tsv.gz").exists()
    assert (out / "features.tsv.gz").exists()


def test_downsample_axis_matches_reference_semantics():
    from merfish3d_tpu.utils.imageprocessing import downsample_axis

    rng = np.random.default_rng(3)
    img = rng.integers(0, 1000, (5, 7, 6), dtype=np.uint16)
    for axis, level in [(0, 2), (1, 3), (2, 4)]:
        out = downsample_axis(img, level=level, axis=axis)
        n = img.shape[axis]
        expected_len = n // level + (1 if n % level else 0)
        assert out.shape[axis] == expected_len
        assert out.dtype == img.dtype
        # naive reference loop on one fibre
        fibre = np.moveaxis(img, axis, 0)[:, 0, 0].astype(np.float64)
        naive = np.array(
            [fibre[i * level : i * level + level].mean() for i in range(expected_len)]
        ).astype(img.dtype)
        np.testing.assert_array_equal(np.moveaxis(out, axis, 0)[:, 0, 0], naive)


def test_small_dataio_utilities(tmp_path):
    from merfish3d_tpu.utils.dataio import (
        read_metadatafile,
        return_data_zarr,
        time_stamp,
        write_metadata,
        write_tsv,
    )
    from merfish3d_tpu.utils.ndtiff import write_ndtiff

    write_metadata({"root_name": "exp", "num_r": 3, "na": 1.35},
                   tmp_path / "scan_metadata.csv")
    meta = read_metadatafile(tmp_path / "scan_metadata.csv")
    assert meta["root_name"] == "exp" and meta["num_r"] == 3

    write_tsv(tmp_path / "out.tsv", ["a", ["b", "c"]])
    assert (tmp_path / "out.tsv").read_text() == "a\nb\tc\n"

    assert len(time_stamp()) == 19

    stack = np.arange(2 * 3 * 4 * 5, dtype=np.uint16).reshape(2, 3, 4, 5)
    write_ndtiff(tmp_path / "acq_1", stack)
    np.testing.assert_array_equal(return_data_zarr(tmp_path / "acq_1", 1), stack[1])
    np.testing.assert_array_equal(
        return_data_zarr(tmp_path / "acq_1" / "acq_1_NDTiffStack.tif", 0), stack[0]
    )


def test_write_ome_tiff_2d(tmp_path):
    from PIL import Image

    from merfish3d_tpu.utils.ometiff import write_ome_tiff_2d

    rng = np.random.default_rng(5)
    plane = rng.integers(0, 2**16, (33, 47), dtype=np.uint16)
    path = write_ome_tiff_2d(tmp_path / "proj.ome.tiff", plane, (0.098, 0.098))

    with Image.open(path) as img:
        arr = np.asarray(img)
        tags = dict(img.tag_v2)
    np.testing.assert_array_equal(arr, plane)
    desc = tags[270]
    assert "OME" in desc and 'SizeX="47"' in desc and 'PhysicalSizeX="0.098"' in desc
    assert tags[296] == 3  # resolution unit: centimeter
    assert abs(float(tags[282]) - 1e4 / 0.098) < 1.0  # pixels per cm


def test_bulkseq_correlation_normalization(tmp_path):
    """Counts-vs-FPKM QC: gene-name normalization (prefix drop + trailing
    dash-number strip), log-log Pearson, scatter export
    (reference `bulkseq_correlation.py:29-268`)."""
    import pandas as pd

    from merfish3d_tpu.cli.qi2lab.bulkseq_correlation import (
        bulkseq_correlation,
        write_scatter,
    )

    rng = np.random.default_rng(0)
    genes = [f"gene{i:02d}" for i in range(12)]
    fpkm_vals = 10 ** rng.uniform(0, 3, 12)
    # decoded counts proportional to FPKM → strong correlation; decoded
    # names carry probe prefixes + trailing -N suffixes
    rows = []
    for g, v in zip(genes, fpkm_vals):
        rows += [{"gene_id": f"probe_{g}-1"}] * max(1, int(v / 10))
    rows += [{"gene_id": "blank01"}] * 5
    decoded = pd.DataFrame(rows)
    fpkm = pd.DataFrame({"gene": genes, "FPKM": fpkm_vals})

    result = bulkseq_correlation(
        decoded, fpkm,
        drop_prefixes=("probe_",),
        strip_trailing_dash_number=True,
    )
    assert result["n_genes"] == 12
    assert result["pearson_r"] > 0.95

    png = tmp_path / "scatter.png"
    write_scatter(result, png)
    assert png.exists() and png.stat().st_size > 1000

    # without normalization nothing matches
    raw = bulkseq_correlation(decoded, fpkm)
    assert raw["n_genes"] == 0


def test_vectorial_psf_properties():
    """Vectorial (Richards-Wolf + interface) PSF: normalized, centered,
    lateral width near the diffraction limit, wider axially than laterally,
    and wider laterally than the scalar Born-Wolf at high NA (the vectorial
    z-component broadens the focal spot; reference uses psfmodels
    vectorial, `chromatic.py:468-487`)."""
    import numpy as np

    from merfish3d_tpu.models.psf import born_wolf_psf, vectorial_psf

    kw = dict(
        emission_wavelength_um=0.67,
        na=1.35,
        ri=1.51,
        voxel_size_zyx_um=(0.25, 0.065, 0.065),
        shape_zyx=(25, 41, 41),
    )
    psf = vectorial_psf(**kw)
    assert psf.shape == (25, 41, 41)
    np.testing.assert_allclose(psf.sum(), 1.0, rtol=1e-5)
    assert np.unravel_index(np.argmax(psf), psf.shape) == (12, 20, 20)
    # lateral FWHM ~ 0.5 lambda / NA = 0.25 um ~ 3.8 px @ 65 nm
    mid = psf[12, 20]
    half = mid.max() / 2
    fwhm_px = np.sum(mid >= half)
    assert 2 <= fwhm_px <= 8, fwhm_px
    # axial extent exceeds lateral extent
    zprof = psf[:, 20, 20]
    fwhm_z_um = np.sum(zprof >= zprof.max() / 2) * 0.25
    assert fwhm_z_um > fwhm_px * 0.065
    # vectorial focal spot is broader than scalar Born-Wolf at NA 1.35
    bw = born_wolf_psf(**kw)
    second_moment = lambda p: float(
        np.sum(p[12, 20] * (np.arange(41) - 20.0) ** 2) / np.sum(p[12, 20])
    )
    assert second_moment(psf) > second_moment(bw) * 0.9


def test_make_channel_psfs_vectorial():
    from merfish3d_tpu.models.psf import make_channel_psfs

    psfs = make_channel_psfs(
        [0.52, 0.67],
        na=1.35,
        ri=1.51,
        voxel_size_zyx_um=(0.31, 0.098, 0.098),
        shape_zyx=(15, 21, 21),
        model="vectorial",
    )
    assert len(psfs) == 2
    # longer wavelength -> broader PSF
    import numpy as np

    m = lambda p: float(np.sum(p[7, 10] * (np.arange(21) - 10.0) ** 2))
    assert m(psfs[1]) > m(psfs[0])


def test_ome_tiff_stack_roundtrip(tmp_path):
    """Multi-channel (C,Z,Y,X) OME-TIFF round-trip with spacing + per-channel
    emission wavelengths in the OME-XML (the reference bead-acquisition
    format, `chromatic.py:100-169`)."""
    import numpy as np

    from merfish3d_tpu.utils.ometiff import (
        read_ome_tiff_stack,
        write_ome_tiff_stack,
    )

    rng = np.random.default_rng(0)
    stack = (rng.random((3, 4, 16, 20)) * 1000).astype(np.uint16)
    path = tmp_path / "beads.ome.tiff"
    write_ome_tiff_stack(
        path, stack, spacing_zyx_um=(0.31, 0.098, 0.098),
        emission_wavelengths_um=[0.52, 0.59, 0.67],
    )
    arr, spacing, wavelengths = read_ome_tiff_stack(path)
    np.testing.assert_array_equal(arr, stack)
    np.testing.assert_allclose(spacing, (0.31, 0.098, 0.098))
    np.testing.assert_allclose(wavelengths, [0.52, 0.59, 0.67])


def test_bead_calibration_from_ome_tiff_cli(tmp_path):
    """Full bead-acquisition parse path: write a 2-channel OME-TIFF with a
    known chromatic shift, run the CLI with --bead-image (metadata-driven
    wavelengths), assert the recovered affine (reference
    `run_chromatic_calibration` ingests a multi-channel OME-TIFF,
    `chromatic.py:752-830,100-169`)."""
    import json

    import numpy as np

    from merfish3d_tpu.cli.qi2lab import chromatic_calibration as cli
    from merfish3d_tpu.datastore import qi2labDataStore
    from merfish3d_tpu.utils.ometiff import write_ome_tiff_stack

    rng = np.random.default_rng(9)
    spacing = np.array([0.31, 0.098, 0.098])
    shape = (16, 96, 96)
    beads_um = np.column_stack(
        [
            rng.uniform(2, 14, 40) * spacing[0],
            rng.uniform(10, 86, 40) * spacing[1],
            rng.uniform(10, 86, 40) * spacing[2],
        ]
    )
    shift_um = np.array([0.0, 0.25, -0.2])

    def render(points_um):
        vol = np.zeros(shape, np.float32)
        zz, yy, xx = np.meshgrid(
            *[np.arange(s, dtype=np.float64) for s in shape], indexing="ij"
        )
        for p in points_um:
            c = p / spacing
            vol += 800 * np.exp(
                -((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
                / (2 * 1.2**2)
            )
        return np.clip(vol + 40, 0, 65535).astype(np.uint16)

    stack = np.stack([render(beads_um), render(beads_um - shift_um)])
    bead_path = tmp_path / "beads.ome.tiff"
    write_ome_tiff_stack(
        bead_path, stack, spacing_zyx_um=spacing,
        emission_wavelengths_um=[0.52, 0.67],
    )

    ds = qi2labDataStore(tmp_path / "qi2labdatastore")
    ds.voxel_size_zyx_um = list(spacing)
    ds.na = 1.35
    ds.ri = 1.51
    cli.main(
        [
            "--datastore-path", str(ds.datastore_path),
            "--bead-image", str(bead_path),
            "--no-deconvolve",
        ]
    )
    attrs = json.loads(
        (ds.datastore_path / "calibrations" / "attributes.json").read_text()
    )
    cal = attrs["chromatic_affine_transforms_zyx_um"]
    ch = cal["channels"]["wavelength_0.670000"]
    assert ch["status"] == "affine_estimated"
    est = np.asarray(ch["affine_zyx_um"])
    np.testing.assert_allclose(est[:3, 3], shift_um, atol=0.08)


def test_estimate_shading_darkfield_option():
    """`get_darkfield=True` returns (flatfield, darkfield) and recovers
    an additive floor (BaSiC model I_i = b_i*S + D + R_i)."""
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, 96), np.linspace(-1, 1, 96), indexing="ij"
    )
    true_flat = 1.0 - 0.35 * (yy**2 + xx**2)
    true_dark = 40.0 * np.ones((96, 96), np.float32)
    imgs = np.stack(
        [
            true_flat * rng.uniform(150, 250) + true_dark
            + rng.normal(0, 2, (96, 96))
            for _ in range(10)
        ]
    ).astype(np.float32)
    flat, dark = estimate_shading(imgs, get_darkfield=True)
    assert flat.shape == (96, 96) and dark.shape == (96, 96)
    assert flat[48, 48] > flat[4, 4] * 1.15  # vignette shape recovered
    assert 0.0 <= dark.mean() <= 80.0  # additive floor in a sane range


def test_bounded_writer_drains_and_reraises():
    from merfish3d_tpu.datastore.prefetch import BoundedWriter

    written = []
    with BoundedWriter(depth=2) as w:
        for i in range(6):
            w.submit(written.append, i)
    assert written == list(range(6))

    with pytest.raises(ValueError, match="boom"):
        with BoundedWriter(depth=1) as w:
            def fail():
                raise ValueError("boom")
            w.submit(fail)
            w.submit(fail)  # blocks on the first future -> re-raises


def test_bounded_writer_error_shuts_thread_down():
    """A failure ends the writer: the caller's error propagates, queued
    jobs are reaped, and the worker thread is gone, so a failed phase can
    never leave a thread that keeps the process from exiting."""
    from merfish3d_tpu.datastore.prefetch import BoundedWriter

    done = []
    with pytest.raises(RuntimeError, match="phase failed"):
        with BoundedWriter(depth=4) as w:
            w.submit(done.append, 1)
            w.submit(done.append, 2)
            raise RuntimeError("phase failed")
    assert done == [1, 2]
    threads = list(w._pool._threads)
    assert threads and not any(t.is_alive() for t in threads)
