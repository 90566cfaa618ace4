"""RLGC deconvolution kernel tests: FFT conv correctness vs scipy, blur
recovery on synthetic Gaussian-blob volumes (the reference test geometry),
and tiled-vs-whole consistency."""

import numpy as np
import pytest
import scipy.ndimage
import scipy.signal

import jax.numpy as jnp

from merfish3d_tpu.ops import fftutils
from merfish3d_tpu.ops.rlgc import chunked_rlgc, rlgc, rlgc_batch


def _gaussian_psf(shape=(7, 11, 11), sigma=(1.2, 1.8, 1.8)):
    zz, yy, xx = np.meshgrid(
        *[np.arange(s) - s // 2 for s in shape], indexing="ij"
    )
    psf = np.exp(
        -0.5 * ((zz / sigma[0]) ** 2 + (yy / sigma[1]) ** 2 + (xx / sigma[2]) ** 2)
    )
    return (psf / psf.sum()).astype(np.float32)


def _blob_volume(shape=(12, 48, 48), n=6, seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    for _ in range(n):
        z, y, x = [rng.integers(3, s - 3) for s in shape]
        vol[z, y, x] = rng.uniform(2000, 8000)
    return vol


def _is_23_smooth(n: int) -> bool:
    for p in (2, 3):
        while n % p == 0:
            n //= p
    return n == 1


def test_next_smooth_fft_size():
    assert fftutils.next_smooth_fft_size(1) == 1
    assert fftutils.next_smooth_fft_size(5) == 6
    assert fftutils.next_smooth_fft_size(17) == 18
    assert fftutils.next_smooth_fft_size(65) == 72
    assert fftutils.next_smooth_fft_size(96) == 96
    # the smallest 2,3-smooth cover, as the reference sizes cuFFT
    for x in (5, 17, 65, 96, 1038, 2062):
        n = fftutils.next_smooth_fft_size(x)
        assert n >= x and _is_23_smooth(n)
        assert not any(_is_23_smooth(m) for m in range(x, n))


# padded axis lengths of real tiles: 2048² camera frames and 1024² crops
# with 15–51 px PSF halos, 16–100-plane stacks with their axial halos
@pytest.mark.parametrize(
    "x,expected",
    [(2048, 2048), (2062, 2187), (2098, 2187), (1038, 1152), (1074, 1152),
     (50, 54), (66, 72), (116, 128)],
)
def test_next_smooth_fft_size_real_widths(x, expected):
    assert fftutils.next_smooth_fft_size(x) == expected


def test_fft_conv_matches_scipy():
    rng = np.random.default_rng(1)
    img = rng.random((8, 24, 24)).astype(np.float32)
    psf = _gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    pad = fftutils.linear_fft_pad_width(img.shape, psf.shape)
    padded = np.asarray(fftutils.pad_symmetric(jnp.asarray(img), pad))
    H = jnp.fft.rfftn(fftutils.pad_psf(jnp.asarray(psf), padded.shape))
    out = np.asarray(fftutils.fft_conv(jnp.asarray(padded), H, padded.shape))
    expected = scipy.signal.fftconvolve(padded, psf, mode="same")
    # circular wrap vs scipy zero-padding differ only inside the halo;
    # compare the retained (interior) region
    interior = tuple(slice(b, s - a) for (b, a), s in zip(pad, padded.shape))
    np.testing.assert_allclose(out[interior], expected[interior], rtol=1e-3, atol=1e-3)


def test_pad_psf_unit_sum():
    psf = _gaussian_psf()
    p = np.asarray(fftutils.pad_psf(jnp.asarray(psf), (16, 36, 36)))
    assert p.shape == (16, 36, 36)
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-5)


def test_rlgc_recovers_blobs():
    """Deconvolution must sharpen a blurred point source: the deconvolved
    image should concentrate more energy at the true blob locations than
    the blurred observation does."""
    truth = _blob_volume()
    psf = _gaussian_psf()
    blurred = scipy.signal.fftconvolve(truth, psf, mode="same")
    rng = np.random.default_rng(2)
    observed = rng.poisson(np.clip(blurred, 0, None) + 2).astype(np.float32)

    decon = rlgc(observed, psf, seed=3, max_iters=60)
    assert decon.shape == truth.shape
    assert np.all(np.isfinite(decon))

    mask = scipy.ndimage.binary_dilation(truth > 0, iterations=1)
    frac_obs = observed[mask].sum() / observed.sum()
    frac_dec = decon[mask].sum() / decon.sum()
    assert frac_dec > 2.0 * frac_obs  # energy concentrated at point sources


def test_rlgc_batch_matches_single():
    truth = _blob_volume()
    psf = _gaussian_psf()
    blurred = scipy.signal.fftconvolve(truth, psf, mode="same")
    observed = np.stack(
        [
            np.random.default_rng(i).poisson(np.clip(blurred, 0, None) + 5)
            for i in range(2)
        ]
    ).astype(np.float32)
    batch = rlgc_batch(observed, psf, seed=10, max_iters=15)
    single0 = rlgc(observed[0], psf, seed=10, max_iters=15)
    np.testing.assert_allclose(batch[0], single0, rtol=1e-4, atol=1e-3)


def test_rlgc_pair_path_matches_unpaired(monkeypatch):
    """The paired solve (two volumes per program, every convolution packed)
    must reproduce the unpaired scan, including the odd-batch remainder."""
    truth = _blob_volume()
    psf = _gaussian_psf()
    blurred = scipy.signal.fftconvolve(truth, psf, mode="same")
    observed = np.stack(
        [
            np.random.default_rng(i).poisson(np.clip(blurred, 0, None) + 5)
            for i in range(3)
        ]
    ).astype(np.float32)
    monkeypatch.setenv("MERFISH3D_RLGC_PAIR", "0")
    unpaired = rlgc_batch(observed, psf, seed=7, max_iters=12)
    monkeypatch.setenv("MERFISH3D_RLGC_PAIR", "1")
    paired = rlgc_batch(observed, psf, seed=7, max_iters=12)
    np.testing.assert_allclose(paired, unpaired, rtol=1e-4, atol=1e-3)


def test_chunked_rlgc_covers_image():
    truth = _blob_volume((8, 64, 64), n=10)
    psf = _gaussian_psf((5, 7, 7))
    blurred = scipy.signal.fftconvolve(truth, psf, mode="same")
    observed = np.random.default_rng(4).poisson(
        np.clip(blurred, 0, None) + 5
    ).astype(np.float32)
    whole = rlgc(observed, psf, seed=5, max_iters=10)
    tiled = chunked_rlgc(observed, psf, crop_yx=32, seed=5, max_iters=10)
    assert tiled.shape == observed.shape
    assert np.all(np.isfinite(tiled))
    # interior agreement (away from tile seams the halo makes tiles ~exact)
    corr = np.corrcoef(whole.ravel(), tiled.ravel())[0, 1]
    assert corr > 0.95


def test_rlgc_diagnostics_variant_matches(caplog):
    """The diagnostics (host-loop) variant must match the jitted while_loop
    solver and emit structured per-iteration records."""
    import logging

    from merfish3d_tpu.ops.rlgc import rlgc_diagnostics

    truth = _blob_volume(shape=(8, 32, 32), n=4, seed=1)
    psf = _gaussian_psf((5, 7, 7))
    blurred = scipy.signal.fftconvolve(truth, psf, mode="same")
    observed = np.random.default_rng(5).poisson(
        np.clip(blurred, 0, None) + 2
    ).astype(np.float32)
    with caplog.at_level(logging.INFO, logger="merfish3d_tpu.rlgc"):
        diag = rlgc_diagnostics(observed, psf, seed=9, max_iters=10)
    ref = rlgc(observed, psf, seed=9, max_iters=10)
    np.testing.assert_allclose(diag, ref, rtol=1e-4, atol=1e-3)
    assert any("iteration=" in r.message for r in caplog.records)


def test_auto_crop_yx_budget():
    """The static memory-budget crop selection (in place of the
    reference's OOM-retry shrink, `rlgc.py:1152-1171`): at the 16 GiB
    reference limit (the CPU's) full 2048-px camera frames tile down,
    small volumes stay untiled."""
    from merfish3d_tpu.ops.rlgc import auto_crop_yx

    psf_shape = (9, 15, 15)
    # production camera frame: must tile below the known-good 1024 solve
    assert auto_crop_yx((48, 2048, 2048), psf_shape) <= 1024
    # small volumes stay whole-frame
    crop = auto_crop_yx((12, 128, 128), psf_shape)
    assert crop >= 128
    # deeper stacks shrink the lateral budget monotonically
    assert auto_crop_yx((96, 2048, 2048), psf_shape) <= auto_crop_yx(
        (16, 2048, 2048), psf_shape
    )


def test_max_vmap_batch_budget():
    """The scan-width budget: 2·B batch stacks + one live working set
    must fit the f32 budget; legacy total-voxel semantics preserved when
    a budget is passed explicitly."""
    from merfish3d_tpu.ops.rlgc import (
        MAX_SCAN_BATCH,
        SCAN_TOTAL_F32_BUDGET,
        _PAIR_WORKING_SET_BUFFERS,
        _SCAN_WORKING_SET_BUFFERS,
        max_vmap_batch,
        pairing_enabled,
    )
    from merfish3d_tpu.ops.fftutils import linear_fft_pad_width

    psf_shape = (9, 15, 15)
    cap = max_vmap_batch((32, 1024, 1024), psf_shape)
    pads = linear_fft_pad_width((32, 1024, 1024), psf_shape)
    padded = 1
    for n, (b, a) in zip((32, 1024, 1024), pads):
        padded *= n + b + a
    ws = (
        _PAIR_WORKING_SET_BUFFERS if pairing_enabled()
        else _SCAN_WORKING_SET_BUFFERS
    )
    expect = int((SCAN_TOTAL_F32_BUDGET / padded - ws) // 2)
    assert cap == max(1, min(expect, MAX_SCAN_BATCH))
    # half a 16-bit readout stack of 1024-px frames rides ONE scan
    assert cap >= 8
    assert max_vmap_batch((12, 128, 128), psf_shape) == MAX_SCAN_BATCH
    # legacy explicit-budget semantics
    assert max_vmap_batch(
        (32, 1024, 1024), psf_shape, budget_padded_voxels=1.4e8
    ) == max(1, int(1.4e8 // padded))


# -- the generic iteration chain against the reference formulas
# (reference `rlgc.py:389-419,598-601,627-693`), in float64 numpy
_SHAPE = (4, 8, 256)
_PAD = ((1, 1), (2, 1), (3, 5))


def _np_kl(p, q, mask, eps=1e-4):
    p = (p.astype(np.float64) + eps) * mask
    q = (q.astype(np.float64) + eps) * mask
    p, q = p / p.sum(), q / q.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        k = p * (np.log(p) - np.log(q))
    return np.nansum(k)


def test_ratio_kld_chain_matches_reference_formulas():
    """Ratios + split KLDs, including the NaN→0 zeroing of negative-Hu
    entries."""
    from merfish3d_tpu.ops.fftutils import observed_region_mask
    from merfish3d_tpu.ops.rlgc import _ratios_klds

    rng = np.random.default_rng(3)
    hu = rng.normal(5.0, 3.0, _SHAPE).astype(np.float32)  # some < 0
    s1 = rng.poisson(4.0, _SHAPE).astype(np.float32)
    s2 = rng.poisson(4.0, _SHAPE).astype(np.float32)
    mask = observed_region_mask(_SHAPE, _PAD)
    r1, r2, k1, k2 = _ratios_klds(
        jnp.asarray(hu), jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(mask)
    )
    denom = 0.5 * (hu.astype(np.float64) + 1e-12)
    np.testing.assert_allclose(np.asarray(r1), mask * (s1 / denom), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r2), mask * (s2 / denom), rtol=1e-6)
    np.testing.assert_allclose(float(k1), _np_kl(hu, s1, mask), rtol=2e-4)
    np.testing.assert_allclose(float(k2), _np_kl(hu, s2, mask), rtol=2e-4)


@pytest.mark.parametrize("restore", [False, True])
def test_update_chain_matches_reference(restore):
    """Consensus-gated update, boundary re-symmetrization, restore select
    and the convergence statistics."""
    from merfish3d_tpu.ops.fftutils import observed_region_mask
    from merfish3d_tpu.ops.rlgc import MIN_STOP_ITERS, _apply_update

    rng = np.random.default_rng(5)
    cons = rng.normal(0.0, 1.0, _SHAPE).astype(np.float32)
    rec = rng.uniform(0.5, 2.0, _SHAPE).astype(np.float32)
    prev = rng.uniform(0.5, 2.0, _SHAPE).astype(np.float32)
    ht = rng.uniform(0.2, 1.8, _SHAPE).astype(np.float32)
    mask = observed_region_mask(_SHAPE, _PAD)
    n_pix = float(mask.sum())
    new, new_prev, k1, k2, it, done = _apply_update(
        jnp.asarray(cons), jnp.asarray(rec), jnp.asarray(prev),
        jnp.asarray(ht), jnp.asarray(restore), (jnp.float32(1.0), jnp.float32(2.0)),
        (jnp.float32(3.0), jnp.float32(4.0)), jnp.int32(MIN_STOP_ITERS),
        pad_width=_PAD, mask=jnp.asarray(mask), num_pixels=n_pix,
        limit=0.01, max_delta=0.001,
    )
    upd = np.where(cons < 0, rec, rec * ht)
    interior = tuple(slice(b, n - a) for n, (b, a) in zip(_SHAPE, _PAD))
    upd = np.pad(upd[interior], _PAD, mode="symmetric")
    np.testing.assert_allclose(np.asarray(new), prev if restore else upd, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(new_prev), prev if restore else rec, rtol=1e-6)
    assert (float(k1), float(k2)) == ((3.0, 4.0) if restore else (1.0, 2.0))
    assert int(it) == MIN_STOP_ITERS + (0 if restore else 1)
    frac = np.sum((cons >= 0) * mask) / n_pix
    rel = np.max(np.abs(upd * mask - rec * mask)) / (upd * mask).max()
    assert bool(done) == (restore or frac < 0.01 or rel < 0.001)


def test_split_ht_neutralizes_unsupported_padding():
    """ht := 1 (the no-op update) wherever the adjoint normalization has
    no mask support; g / norm elsewhere."""
    from merfish3d_tpu.ops.rlgc import _split_ht

    norm = np.array([1e-6, 5e-4, 1e-3, 0.5, 1.0], np.float32)
    gr = np.array([3.0, 3.0, 3.0, 3.0, 3.0], np.float32)
    gi = np.array([1.0, 1.0, 1.0, 1.0, 1.0], np.float32)
    h1, h2 = _split_ht(jnp.asarray(gr), jnp.asarray(gi), jnp.asarray(norm))
    np.testing.assert_allclose(np.asarray(h1), [1, 1, 3e3, 6, 3], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(h2), [1, 1, 1e3, 2, 1], rtol=1e-6)


def test_binomial_half_is_exact_and_centered():
    """The photon split: exact popcount draws up to 32 counts (every
    draw within [0, n]), normal approximation beyond, mean n/2."""
    import jax

    from merfish3d_tpu.ops.rlgc import _binomial_half

    counts = np.repeat(np.array([0, 1, 7, 32, 33, 500], np.int32), 4000)
    draws = np.asarray(_binomial_half(jax.random.PRNGKey(0), jnp.asarray(counts)))
    assert np.all((draws >= 0) & (draws <= counts))
    assert np.all(draws == np.round(draws))
    for n in (1, 7, 32, 33, 500):
        sel = draws[counts == n]
        assert abs(sel.mean() - n / 2) < 4 * np.sqrt(n / 4 / sel.size) + 1e-9
        assert abs(sel.var() - n / 4) < 0.15 * n / 4
