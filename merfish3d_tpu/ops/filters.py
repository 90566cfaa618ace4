"""Separable image filters and resampling ops.

JAX replacements for cupyx.scipy.ndimage filters used by the
reference: Gaussian lowpass (`PixelDecoder._lowpass_image:1597-1630`,
σ=(3,1,1) default), hot-pixel median replacement
(`utils/imageprocessing.replace_hot_pixels:59`), and numba anisotropic
mean downsampling (`utils/imageprocessing.downsample_image_anisotropic:147-223`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Matches scipy.ndimage.gaussian_filter1d kernel construction."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_axis(vol: jnp.ndarray, kernel: np.ndarray, axis: int) -> jnp.ndarray:
    """Reflect-padded 1D convolution along one axis of a volume, as a sum
    of shifted slices: XLA fuses the taps into one elementwise pass that
    reads the padded volume and writes the output once. (A ``lax.conv``
    with one channel plans its temporaries at ~100× the volume on the GPU,
    more than a card holds at production geometry.)"""
    r = (kernel.shape[0] - 1) // 2
    pad = [(0, 0)] * vol.ndim
    pad[axis] = (r, r)
    # scipy.ndimage "reflect" == np.pad "symmetric"
    padded = jnp.pad(vol, pad, mode="symmetric")
    n = vol.shape[axis]
    out = None
    for i, w in enumerate(kernel.tolist()):
        term = jax.lax.slice_in_dim(padded, i, i + n, axis=axis) * np.float32(w)
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("sigma", "truncate"))
def gaussian_lowpass(
    volume: jnp.ndarray, sigma=(3.0, 1.0, 1.0), truncate: float = 4.0
) -> jnp.ndarray:
    """Separable Gaussian filter (reflect boundary), matching
    scipy/cupyx ``gaussian_filter`` semantics. ``sigma`` is per-axis over
    the trailing 3 dims; sigma 0 skips the axis (2D per-plane mode)."""
    vol = volume.astype(jnp.float32)
    lead = vol.ndim - 3
    for ax, s in enumerate(sigma):
        if s and s > 0:
            k = _gaussian_kernel1d(float(s), truncate)
            vol = _conv_axis(vol, k, lead + ax)
    return vol


@partial(jax.jit, static_argnames=())
def _median3x3_plane(plane: jnp.ndarray) -> jnp.ndarray:
    """3x3 median over the 9 shifted neighbours."""
    padded = jnp.pad(plane, 1, mode="reflect")
    stack = jnp.stack(
        [
            padded[dy : dy + plane.shape[0], dx : dx + plane.shape[1]]
            for dy in range(3)
            for dx in range(3)
        ]
    )
    return jnp.median(stack, axis=0)


def replace_hot_pixels(
    noise_map: np.ndarray, images: np.ndarray, threshold: float = 375.0
) -> np.ndarray:
    """Replace hot pixels (noise map above threshold) with the local 3x3
    median, per plane (reference `imageprocessing.replace_hot_pixels:28-88`)."""
    noise_map = jnp.asarray(noise_map, jnp.float32)
    hot = noise_map > threshold
    imgs = jnp.asarray(images, jnp.float32)
    if imgs.ndim == 2:
        imgs = imgs[None]
    med = jax.vmap(_median3x3_plane)(imgs)
    out = jnp.where(hot[None] if hot.ndim == 2 else hot, med, imgs)
    return np.asarray(out.astype(jnp.uint16))


def downsample_image_anisotropic(
    image: np.ndarray, factors: tuple[int, int, int]
) -> np.ndarray:
    """Anisotropic mean downsampling by integer factors (reference
    `imageprocessing.downsample_image_anisotropic:147-223`, numba prange →
    block-mean reshape on device)."""
    image = np.asarray(image)
    fz, fy, fx = (int(f) for f in factors)
    nz, ny, nx = image.shape
    tz, ty, tx = nz // fz * fz, ny // fy * fy, nx // fx * fx
    trimmed = jnp.asarray(image[:tz, :ty, :tx], jnp.float32)
    out = trimmed.reshape(tz // fz, fz, ty // fy, fy, tx // fx, fx).mean(
        axis=(1, 3, 5)
    )
    return np.asarray(out)
