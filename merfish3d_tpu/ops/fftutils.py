"""FFT sizing, linear-convolution padding, and cached FFT convolution.

JAX equivalents of the reference FFT helpers
(reference `utils/rlgc.py:73-360`): 2,3-smooth FFT sizes, symmetric
linear-convolution padding, centered/ifftshifted PSF embedding, and
``irfftn(rfftn(x) * H)`` convolution. Under jit, XLA preplans the FFTs, so no
explicit plan caching is needed (the reference caches cuFFT buffers).

All functions are pure and shape-static, so they can live inside
``lax.while_loop`` bodies and be vmapped over a leading batch axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def next_smooth_fft_size(x: int) -> int:
    """Smallest 2,3-smooth integer >= x: the padded FFT axis length
    (reference `rlgc.py:73-103`, which sizes its cuFFT transforms the
    same way)."""
    if x <= 1:
        return 1
    n = int(x)
    while True:
        m = n
        for p in (2, 3):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def axis_linear_fft_padding(
    length: int, psf_support: int, halo_multiplier: int = 1
) -> tuple[int, int]:
    """Per-axis (before, after) padding: PSF halo + growth to a smooth FFT
    size (reference `rlgc.py:105-135`)."""
    halo = max((int(psf_support) // 2) * int(halo_multiplier), 0)
    length_with_halo = length + 2 * halo
    new_length = next_smooth_fft_size(length_with_halo)
    fft_extra = new_length - length_with_halo
    pad_before = halo + fft_extra // 2
    pad_after = halo + fft_extra - fft_extra // 2
    return pad_before, pad_after


PadWidth = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]


def linear_fft_pad_width(
    image_shape: tuple[int, int, int],
    psf_shape: tuple[int, int, int],
    pad_yx: bool = True,
) -> PadWidth:
    """Static pad widths for linear FFT conv (reference `rlgc.py:136-176`)."""
    pad_z = axis_linear_fft_padding(image_shape[0], psf_shape[0])
    if pad_yx:
        pad_y = axis_linear_fft_padding(image_shape[1], psf_shape[1])
        pad_x = axis_linear_fft_padding(image_shape[2], psf_shape[2])
    else:
        pad_y = (0, 0)
        pad_x = (0, 0)
    return (pad_z, pad_y, pad_x)


def pad_symmetric(image: jnp.ndarray, pad_width: PadWidth) -> jnp.ndarray:
    """Symmetric (reflect-including-edge) padding; static widths."""
    return jnp.pad(image, pad_width, mode="symmetric")


def remove_padding_zyx(arr: jnp.ndarray, pad_width: PadWidth) -> jnp.ndarray:
    slices = tuple(
        slice(b, arr.shape[i] - a if a > 0 else None)
        for i, (b, a) in enumerate(pad_width)
    )
    return arr[slices]


def enforce_symmetric_boundary(arr: jnp.ndarray, pad_width: PadWidth) -> jnp.ndarray:
    """Rebuild the padding region as a symmetric reflection of the interior
    (reference `rlgc.py:235-277`). Static shapes: crop then re-pad."""
    return pad_symmetric(remove_padding_zyx(arr, pad_width), pad_width)


def observed_region_mask(shape: tuple[int, ...], pad_width: PadWidth) -> np.ndarray:
    """Binary mask of the original (unpadded) image region
    (reference `rlgc.py:359-387`)."""
    mask = np.zeros(shape, dtype=np.float32)
    slices = tuple(
        slice(b, shape[i] - a if a > 0 else None)
        for i, (b, a) in enumerate(pad_width)
    )
    mask[slices] = 1.0
    return mask


def observed_region_mask_device(
    shape: tuple[int, ...], pad_width: PadWidth
) -> jnp.ndarray:
    """On-device mask of the unpadded region, built from iota comparisons.

    A NumPy mask constant would be baked into the jitted program: about
    1 GB of constant at production padded shapes, carried by every compile
    and every compile-cache entry. Iotas compile to O(1) metadata instead.
    """
    mask = None
    for ax, (before, after) in enumerate(pad_width):
        pos = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        ok = (pos >= before) & (pos < shape[ax] - after)
        mask = ok if mask is None else (mask & ok)
    return mask.astype(jnp.float32)


def pad_psf(
    psf: jnp.ndarray, image_shape: tuple[int, int, int], normalize: bool = True
) -> jnp.ndarray:
    """Embed + center a PSF into the padded image shape and ifftshift it so
    that `irfftn(rfftn(x) * rfftn(psf))` is a centered convolution
    (reference `rlgc.py:280-319`)."""
    psf = jnp.asarray(psf, jnp.float32)
    if psf.ndim == 2:
        psf = psf[None]
    embedded = jnp.zeros(image_shape, jnp.float32)
    embedded = embedded.at[
        : psf.shape[0], : psf.shape[1], : psf.shape[2]
    ].set(psf)
    for axis, axis_size in enumerate(image_shape):
        embedded = jnp.roll(embedded, int(axis_size / 2), axis=axis)
    for axis, axis_size in enumerate(psf.shape):
        embedded = jnp.roll(embedded, -int(axis_size / 2), axis=axis)
    embedded = jnp.fft.ifftshift(embedded)
    if normalize:
        s = jnp.sum(embedded)
        embedded = embedded / jnp.where(s != 0, s, 1.0)
    return embedded.astype(jnp.float32)


def fft_conv(image: jnp.ndarray, H: jnp.ndarray, shape: tuple[int, int, int]) -> jnp.ndarray:
    """Linear convolution ``irfftn(rfftn(image) * H, s=shape)`` in float32
    (reference `rlgc.py:322-356`). XLA fuses and preplans the transforms."""
    f = jnp.fft.rfftn(image)
    return jnp.fft.irfftn(f * H, s=shape).astype(jnp.float32)


# ------------------------------------------------ complex pairs
# Complex spectra travel as (real, imag) float32 pairs. A real-kernel
# convolution of a packed pair a + i·b is conv(a, k) + i·conv(b, k), so
# two real volumes share one transform (the RLGC adjoint and the paired
# two-slot solve rely on this).


def fftn_pair(xr: jnp.ndarray, xi=None):
    """Full-spectrum N-D DFT on a (real, imag) float32 pair → (real, imag)."""
    z = xr.astype(jnp.complex64)
    if xi is not None:
        z = z + 1j * xi.astype(jnp.complex64)
    f = jnp.fft.fftn(z)
    return jnp.real(f).astype(jnp.float32), jnp.imag(f).astype(jnp.float32)


def ifftn_pair(xr: jnp.ndarray, xi: jnp.ndarray):
    z = xr.astype(jnp.complex64) + 1j * xi.astype(jnp.complex64)
    f = jnp.fft.ifftn(z)
    return jnp.real(f).astype(jnp.float32), jnp.imag(f).astype(jnp.float32)


def c_mul(a, b):
    """(ar, ai) * (br, bi) elementwise complex product on pairs."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def c_conj(a):
    ar, ai = a
    return ar, -ai


def fftn_spec(xr: jnp.ndarray, xi=None):
    """Forward N-D DFT pair, spectrum in numpy order (:func:`spectrum_freqs`)."""
    return fftn_pair(xr, xi)


def ifftn_spec(xr: jnp.ndarray, xi: jnp.ndarray, real_output: bool = False):
    """Inverse of :func:`fftn_spec`. ``real_output=True`` returns
    ``(real, None)`` for callers that keep only the real channel."""
    yr, yi = ifftn_pair(xr, xi)
    return (yr, None) if real_output else (yr, yi)


def spectrum_freqs(n: int) -> np.ndarray:
    """1-D frequency values (cycles/sample) of :func:`fftn_spec`'s
    spectrum order for an axis of length n."""
    return np.fft.fftfreq(n).astype(np.float32)


def fft_conv_spec(xr: jnp.ndarray, xi, H_pair, real_output: bool = False):
    """Convolution of a (real, imag) pair with an OTF pair given in
    :func:`fftn_spec` order."""
    f = fftn_spec(xr, xi)
    return ifftn_spec(*c_mul(f, H_pair), real_output=real_output)


def fft_conv_full(image: jnp.ndarray, H_pair) -> jnp.ndarray:
    """Linear convolution via the full spectrum carried as real pairs;
    numerically equal to :func:`fft_conv` for real inputs."""
    yr, _yi = fft_conv_spec(image, None, H_pair, real_output=True)
    return yr.astype(jnp.float32)
