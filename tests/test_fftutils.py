"""The (real, imag) pair transforms of `ops/fftutils.py` against numpy's
FFT: forward order, round trips, the convolution theorem, ``real_output``
and the frequency order `spectrum_freqs` reports."""

import jax.numpy as jnp
import numpy as np
import pytest

from merfish3d_tpu.ops import fftutils


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [2, 3, 7, 16, 48, 96, 144, 1152])
def test_fft_1d_matches_numpy(n):
    x = _complex(n, n)
    fr, fi = fftutils.fftn_pair(jnp.asarray(x.real), jnp.asarray(x.imag))
    ref = np.fft.fft(x)
    got = np.asarray(fr) + 1j * np.asarray(fi)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(6, 24, 36), (12, 36, 100), (4, 128, 144)])
def test_pair_roundtrip_matches_numpy(shape):
    """Real input: the forward pair is numpy's spectrum in natural order
    (what `spectrum_freqs` reports), and the inverse restores the input
    with a zero imaginary channel."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    fr, fi = fftutils.fftn_spec(jnp.asarray(x))
    ref = np.fft.fftn(x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(fr), ref.real, atol=3e-6 * scale)
    np.testing.assert_allclose(np.asarray(fi), ref.imag, atol=3e-6 * scale)
    yr, yi = fftutils.ifftn_spec(fr, fi)
    np.testing.assert_allclose(np.asarray(yr), x, atol=1e-5 * np.abs(x).max())
    np.testing.assert_allclose(np.asarray(yi), 0.0, atol=1e-5 * np.abs(x).max())


def test_complex_roundtrip_3d():
    x = _complex((6, 24, 36), 0)
    fr, fi = fftutils.fftn_pair(jnp.asarray(x.real), jnp.asarray(x.imag))
    yr, yi = fftutils.ifftn_pair(fr, fi)
    np.testing.assert_allclose(np.asarray(yr), x.real, atol=1e-5)
    np.testing.assert_allclose(np.asarray(yi), x.imag, atol=1e-5)


def test_pair_conv_matches_numpy():
    """Convolution through pair spectra == numpy's circular convolution."""
    rng = np.random.default_rng(7)
    vol = rng.standard_normal((8, 48, 60)).astype(np.float32)
    kern = rng.standard_normal((8, 48, 60)).astype(np.float32)
    H = fftutils.fftn_spec(jnp.asarray(kern))
    got = np.asarray(fftutils.fft_conv_full(jnp.asarray(vol), H))
    ref = np.real(np.fft.ifftn(np.fft.fftn(vol) * np.fft.fftn(kern)))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_packed_pair_conv_is_two_real_convs():
    """A real kernel convolves a packed a + i·b as conv(a) + i·conv(b):
    the identity the RLGC adjoint and paired solve ride on."""
    rng = np.random.default_rng(8)
    a, b, kern = (rng.standard_normal((6, 20, 28)).astype(np.float32) for _ in range(3))
    H = fftutils.fftn_spec(jnp.asarray(kern))
    gr, gi = fftutils.fft_conv_spec(jnp.asarray(a), jnp.asarray(b), H)
    np.testing.assert_allclose(
        np.asarray(gr), np.asarray(fftutils.fft_conv_full(jnp.asarray(a), H)), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(gi), np.asarray(fftutils.fft_conv_full(jnp.asarray(b), H)), atol=1e-4
    )


def test_full_spectrum_conv_equals_half_spectrum_conv():
    """`fft_conv_full` (pair spectra) == `fft_conv` (rfftn/irfftn)."""
    rng = np.random.default_rng(3)
    shape = (10, 32, 40)
    vol = rng.standard_normal(shape).astype(np.float32)
    psf = fftutils.pad_psf(jnp.asarray(rng.random((3, 5, 5)), jnp.float32), shape)
    full = fftutils.fft_conv_full(jnp.asarray(vol), fftutils.fftn_spec(psf))
    half = fftutils.fft_conv(jnp.asarray(vol), jnp.fft.rfftn(psf), shape)
    np.testing.assert_allclose(np.asarray(full), np.asarray(half), atol=1e-5)


def test_real_output_drops_imaginary_channel():
    x = np.random.default_rng(10).normal(size=(8, 16)).astype(np.float32)
    fr, fi = fftutils.fftn_spec(jnp.asarray(x))
    yr, yi = fftutils.ifftn_spec(fr, fi, real_output=True)
    assert yi is None
    np.testing.assert_allclose(np.asarray(yr), x, atol=1e-5)
    cr, ci = fftutils.fft_conv_spec(jnp.asarray(x), None, (fr, fi), real_output=True)
    assert ci is None and cr.shape == x.shape


@pytest.mark.parametrize("n", [2, 7, 48, 100, 144])
def test_spectrum_freqs_is_fftn_spec_order(n):
    """A delta at position d has spectrum exp(-2πi f d) at the frequencies
    `spectrum_freqs` lists, in `fftn_spec`'s order."""
    d = min(3, n - 1)
    x = np.zeros(n, np.float32)
    x[d] = 1.0
    fr, fi = fftutils.fftn_spec(jnp.asarray(x))
    spec = np.asarray(fr) + 1j * np.asarray(fi)
    expect = np.exp(-2j * np.pi * fftutils.spectrum_freqs(n) * d)
    np.testing.assert_allclose(spec, expect, atol=1e-5)
