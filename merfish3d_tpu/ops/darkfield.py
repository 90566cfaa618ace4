"""Dark-channel dehazing / darkfield sectioning toolkit.

JAX reimplementation of the reference standalone module
(`utils/darkfield.py:1-518`, CuPy): the full dark-sectioning recipe —
frequency split of each plane into high/low bands keyed to the optical
PSF (`separate_hi_lo`), a PSF-support-derived dark-channel window
(`confirm_block`), dark-channel-prior dehazing of the low band with a
spatially varying atmosphere from the low-frequency envelope
(`dehaze_fast2`), and hi + lo recombination (`dark_sectioning`).

Structure: the reference loops z planes serially on the GPU; here
the Fourier filters and the block size are computed once per volume on
the host (they depend only on geometry + optics), and every z plane runs
through ONE jitted, vmapped program — band split, dark channels,
transmissions and the guided filter are all batched element/window-wise
VPU work, and the FFTs batch over the plane axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------- windows
def window_sum_filter(image2d: jnp.ndarray, r: int) -> jnp.ndarray:
    """Local windowed SUM over a (2r+1)² box via two cumulative-sum
    passes with edge replication (reference `darkfield.py:9-44`)."""
    x = jnp.asarray(image2d)
    for axis in (-2, -1):
        n = x.shape[axis]
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r + 1, r)
        csum = jnp.cumsum(jnp.pad(x, pad, mode="edge"), axis=axis)
        hi = jax.lax.slice_in_dim(csum, 2 * r + 1, 2 * r + 1 + n, axis=axis)
        lo = jax.lax.slice_in_dim(csum, 0, n, axis=axis)
        x = hi - lo
    return x


def _box_filter_1d(x: jnp.ndarray, radius: int, axis: int) -> jnp.ndarray:
    """Mean filter along one axis via padded cumulative sums."""
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius + 1, radius)
    padded = jnp.pad(x, pad, mode="edge")
    csum = jnp.cumsum(padded, axis=axis)
    hi = jax.lax.slice_in_dim(csum, 2 * radius + 1, 2 * radius + 1 + n, axis=axis)
    lo = jax.lax.slice_in_dim(csum, 0, n, axis=axis)
    return (hi - lo) / (2 * radius + 1)


def box_filter(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """2D mean filter over the trailing two axes."""
    x = _box_filter_1d(x, radius, axis=-2)
    return _box_filter_1d(x, radius, axis=-1)


# --------------------------------------------------------- Fourier filters
def lpgauss(h: int, w: int, sigma: float) -> np.ndarray:
    """2D Gaussian low-pass in the Fourier domain, DC at [0, 0]
    (reference `darkfield.py:47-70`: exp(-(X²+Y²)/σ²), ifftshifted)."""
    x = np.arange(-(w // 2), w - w // 2, dtype=np.float32)
    y = np.arange(-(h // 2), h - h // 2, dtype=np.float32)
    X, Y = np.meshgrid(x, y)
    return np.fft.ifftshift(np.exp(-(X**2 + Y**2) / (sigma**2))).astype(np.float32)


def hpgauss(h: int, w: int, sigma: float) -> np.ndarray:
    """Complementary high-pass (reference `darkfield.py:72-90`)."""
    return (1.0 - lpgauss(h, w, sigma)).astype(np.float32)


def psf_generator(
    lam: float, pixel_size: float, na: float, w: int, factor: float
) -> np.ndarray:
    """Airy-pattern pupil PSF |2·J1(kR)/(kR)|² on a w×w grid with
    wrap-around radial coordinates, fftshifted (reference
    `darkfield.py:93-124`). Host setup work — one small kernel per
    volume keys the filter bank; the per-plane compute is what runs
    on device."""
    from scipy.special import j1

    coords = np.linspace(0, w - 1, w, dtype=np.float64)
    X, Y = np.meshgrid(coords, coords)
    scale = 2.0 * np.pi * na / lam * pixel_size * factor
    eps = np.finfo(np.float32).eps
    R = np.sqrt(np.minimum(X, np.abs(X - w)) ** 2 + np.minimum(Y, np.abs(Y - w)) ** 2)
    arg = scale * R + eps
    psf = np.abs(2.0 * j1(arg) / arg) ** 2
    psf /= psf.sum()
    return np.fft.fftshift(psf).astype(np.float32)


def separate_hi_lo(
    image2d, params: dict, deg: float, divide: float
):
    """Split a plane into high/low bands + low-frequency envelope keyed
    to the optical resolution (reference `darkfield.py:127-161`).
    Returns (hi, lo, lp_filter, el)."""
    img = jnp.asarray(image2d, jnp.float32)
    h, w = img.shape
    lp, hp, elp = _band_filters((h, w), params, deg, divide)
    hi, lo, el = _separate_device(img, jnp.asarray(lp), jnp.asarray(hp), jnp.asarray(elp))
    return hi, lo, lp, el


def _band_filters(shape_hw, params: dict, deg: float, divide: float):
    """Host-side filter bank (lp, hp, envelope-lp) for one geometry."""
    h, w = shape_hw
    res = 0.5 * params["emwavelength"] / params["NA"] / params["factor"]
    k_m = w / (res / params["pixelsize"])
    kc = int(np.floor(k_m * 0.2))
    sigma_lp = max(kc * 2 / 2.355, 1e-3)
    lp = lpgauss(h, w, sigma_lp * 2 * divide)
    hp = hpgauss(h, w, sigma_lp * 2 * divide)
    elp = lpgauss(h, w, sigma_lp / deg)
    return lp, hp, elp


@jax.jit
def _separate_device(img, lp, hp, elp):
    """One batched FFT split: the three band images share one forward
    transform (the filters are real-even, so the real spectrum works)."""
    spec = jnp.fft.fft2(img)
    hi = jnp.real(jnp.fft.ifft2(spec * hp))
    lo = jnp.real(jnp.fft.ifft2(spec * lp))
    el = jnp.real(jnp.fft.ifft2(spec * elp))
    return hi, lo, el


def confirm_block(params: dict, lp: np.ndarray) -> int:
    """Dark-channel window radius = where the low-passed PSF drops below
    1% of its peak (reference `darkfield.py:164-196`)."""
    psf = psf_generator(
        params["emwavelength"],
        params["pixelsize"],
        params["NA"],
        params["Nx"],
        params["factor"],
    )
    lp = np.asarray(lp)
    psf_lo = np.abs(
        np.fft.ifft2(np.fft.fftshift(np.fft.fft2(psf)) * np.fft.fftshift(lp))
    )
    psf_lo /= psf_lo.max()
    center = params["Nx"] // 2
    profile = psf_lo[center:, center]
    below = np.nonzero(profile < 0.01)[0]
    return int(below[0]) if len(below) else params["Nx"] - center


# ----------------------------------------------------- dark channel prior
def get_dark_channel(image2d: jnp.ndarray, win_size: int) -> jnp.ndarray:
    """Local minimum over a win_size² window (reference
    `darkfield.py:251-267`, reflect boundary)."""
    img = jnp.asarray(image2d, jnp.float32)
    pad_b = (win_size - 1) // 2
    pad_a = win_size - 1 - pad_b
    padded = jnp.pad(img, ((pad_b, pad_a), (pad_b, pad_a)), mode="reflect")
    return -jax.lax.reduce_window(
        -padded, -jnp.inf, jax.lax.max, (win_size, win_size), (1, 1), "VALID"
    )


def get_atmosphere(image2d: jnp.ndarray, dark_channel: jnp.ndarray) -> jnp.ndarray:
    """Mean intensity over the brightest 1% of dark-channel pixels
    (reference `darkfield.py:270-289` takes the exact top-n_search by
    argsort; the quantile-masked mean is its dense, sort-free analog —
    identical up to ties at the cut)."""
    img = jnp.asarray(image2d, jnp.float32)
    dark = jnp.asarray(dark_channel, jnp.float32)
    threshold = jnp.quantile(dark, 0.99)
    mask = dark >= threshold
    return jnp.sum(img * mask) / jnp.maximum(jnp.sum(mask), 1)


def get_transmission_estimate(
    rep_atm, image2d: jnp.ndarray, omega: float, win_size: int
) -> jnp.ndarray:
    """1 - ω·darkchannel(I/A) (reference `darkfield.py:292-314`)."""
    return 1.0 - omega * get_dark_channel(
        jnp.asarray(image2d, jnp.float32) / rep_atm, win_size
    )


@partial(jax.jit, static_argnames=("radius",))
def guided_filter(
    guide: jnp.ndarray, src: jnp.ndarray, radius: int = 15, eps: float = 1e-3
) -> jnp.ndarray:
    """He et al. guided filter (edge-preserving smoothing of ``src``
    guided by ``guide``; reference `darkfield.py:317-359`)."""
    guide = jnp.asarray(guide, jnp.float32)
    src = jnp.asarray(src, jnp.float32)
    radius = min(
        radius, (guide.shape[-2] - 1) // 2, (guide.shape[-1] - 1) // 2
    )
    mean_i = box_filter(guide, radius)
    mean_p = box_filter(src, radius)
    corr_ip = box_filter(guide * src, radius)
    corr_ii = box_filter(guide * guide, radius)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box_filter(a, radius) * guide + box_filter(b, radius)


def get_radiance(rep_atm, image2d: jnp.ndarray, transmission: jnp.ndarray):
    """Invert the haze model with the t ≥ 0.1 floor (reference
    `darkfield.py:362-383`)."""
    img = jnp.asarray(image2d, jnp.float32)
    t = jnp.maximum(jnp.asarray(transmission, jnp.float32), 0.1)
    return (img - rep_atm) / t + rep_atm


def dehaze_fast2(
    image2d,
    omega: float = 0.95,
    win_size: int = 15,
    el=None,
    dep: float = 1.0,
    thres=None,
) -> jnp.ndarray:
    """Dark-channel dehazing of one (low-frequency) plane (reference
    `darkfield.py:198-248`): atmosphere bracketed between a
    low-intensity-masked estimate and the full-image estimate, spread
    spatially by the low-frequency envelope ``el``, then
    transmission → guided refinement → radiance.

    With ``el=None`` the atmosphere is the scalar full-image estimate
    (the classic dark-channel prior — used by the standalone per-plane
    entry point; the full `dark_sectioning` recipe always passes the
    envelope)."""
    img = jnp.asarray(image2d, jnp.float32)
    h, w = img.shape
    win_size = min(int(win_size), h, w)
    if win_size % 2 == 0:
        win_size = max(1, win_size - 1)

    dc_full = get_dark_channel(img, win_size)
    max_atm = get_atmosphere(img, dc_full)
    if el is None:
        rep_atm = max_atm * dep
    else:
        if thres is None:
            thres = 50.0
        mask = (img < thres).astype(jnp.float32)
        dc_masked = get_dark_channel(img * mask, win_size)
        min_atm = get_atmosphere(img * mask, dc_masked)
        el_c = jnp.asarray(el, jnp.float32)
        el_c = el_c - el_c.min()
        el_max = jnp.maximum(el_c.max(), jnp.finfo(jnp.float32).eps)
        rep_atm = (el_c / el_max * (max_atm - min_atm) + min_atm) * dep

    trans_est = get_transmission_estimate(rep_atm, img, omega, win_size)
    refined = guided_filter(img, trans_est, 15, 0.001)
    return get_radiance(rep_atm, img, refined)


# ------------------------------------------------------------ 3D recipe
def dark_sectioning(
    input_image: np.ndarray,
    emwavelength: float = 0.58,
    na: float = 1.35,
    pixel_size: float = 0.098,
    factor: float = 1.0,
    z_chunk: "int | None" = None,
) -> np.ndarray:
    """3D dark-sectioning dehazing (reference `darkfield.py:386-518`):
    normalize to [0, 255], square-pad, symmetric-pad by shape/40, split
    each plane into hi/lo bands keyed to the PSF, dehaze the low band
    with the envelope-driven atmosphere and the `confirm_block` window,
    recombine ``lo/2 + hi``, crop, rescale to uint16.

    Batched: the reference's serial per-plane GPU loop becomes a
    vmapped jitted program over bounded z chunks (one compiled shape, the
    last chunk padded); filters and the block size are host setup shared
    by every plane. ``z_chunk=None`` sizes the chunk to a ~2 GiB HBM
    working-set budget (≈15 live plane-sized buffers per plane), the same
    static-budget discipline as the RLGC/warp batching."""
    vol = np.asarray(input_image, np.float32)
    if vol.ndim == 2:
        vol = vol[None]
    nz, ny0, nx0 = vol.shape

    mn, mx = float(vol.min()), float(vol.max())
    vol = 255.0 * (vol - mn) / max(mx - mn, 1e-12)

    # square-pad the plane, then symmetric-pad for the convolutions
    side = max(ny0, nx0)
    vol = np.pad(vol, ((0, 0), (0, side - ny0), (0, side - nx0)))
    pad = side // 40 + 1
    planes = np.pad(vol, ((0, 0), (pad, pad), (pad, pad)), mode="symmetric")
    h = w = side + 2 * pad

    # reference one-pass operating point (`darkfield.py:455-462`,
    # background=False): deg=10, dep=0.7, hi/lo mix 1:2, thres=50
    deg, dep, hl, thres, divide = 10.0, 0.7, 2.0, 50.0, 0.5
    params = {
        "Nx": h,
        "Ny": w,
        "NA": na,
        "emwavelength": emwavelength,
        "pixelsize": pixel_size,
        "factor": factor,
    }
    lp, hp, elp = _band_filters((h, w), params, deg, divide)
    block = confirm_block(params, lp)
    win = max(1, min(2 * block + 1, h, w))
    if win % 2 == 0:
        win -= 1

    @jax.jit
    def plane_program(stack):
        def one(img):
            hi, lo, el = _separate_device(
                img, jnp.asarray(lp), jnp.asarray(hp), jnp.asarray(elp)
            )
            lo_dehazed = dehaze_fast2(
                lo, omega=0.95, win_size=win, el=el, dep=dep, thres=thres
            )
            return lo_dehazed / hl + hi

        return jax.vmap(one)(stack)

    if z_chunk is None:
        per_plane_bytes = 15 * h * w * 4
        z_chunk = max(1, int(2 * 1024**3 // per_plane_bytes))
    z_chunk = min(max(1, int(z_chunk)), nz)

    chunks = []
    for start in range(0, nz, z_chunk):
        block = planes[start : start + z_chunk]
        n_pad = z_chunk - block.shape[0]
        if n_pad:  # pad to the compiled chunk shape (one program for all)
            block = np.concatenate([block, block[-1:].repeat(n_pad, axis=0)])
        out = np.asarray(plane_program(jnp.asarray(block, jnp.float32)))
        chunks.append(out[: z_chunk - n_pad] if n_pad else out)
    result = np.concatenate(chunks, axis=0)
    result = result[:, pad : pad + ny0, pad : pad + nx0]
    result = result / max(float(result.max()), 1e-12) * 65535.0
    return np.clip(result, 0.0, 65535.0).astype(np.uint16)
