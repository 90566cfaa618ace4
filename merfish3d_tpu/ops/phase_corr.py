"""Phase cross-correlation registration.

JAX replacement for cuCIM's ``phase_cross_correlation``
(used by the reference at `multiview_registration.py:289-310,624-832`):

- cross-power spectrum (phase normalization) + argmax for the integer shift,
- Guizar-Sicairos upsampled-DFT subpixel refinement expressed as dense
  matrix products (no host round-trip),
- candidate disambiguation via masked normalized cross-correlation over the
  2^d (shift, shift-size) sign candidates, evaluated with static-shape
  circular rolls + validity masks (replaces skimage's dynamic slicing).

Shift convention matches skimage: the returned "push" shift applied to
``moving`` (e.g. ``scipy.ndimage.shift``) aligns it to ``fixed``.
"""

from __future__ import annotations

import itertools
from functools import partial

import jax
import jax.numpy as jnp

from .fftutils import c_conj, c_mul, fftn_spec, ifftn_spec, spectrum_freqs
import numpy as np


def _cross_power_spectrum(fixed: jnp.ndarray, moving: jnp.ndarray):
    """Phase-normalized cross-power spectrum as a (real, imag) float32
    pair (see ``fftutils.fftn_spec``)."""
    F = fftn_spec(fixed.astype(jnp.float32))
    M = fftn_spec(moving.astype(jnp.float32))
    rr, ri = c_mul(F, c_conj(M))
    mag = jnp.maximum(jnp.sqrt(rr * rr + ri * ri), 1e-20)
    return rr / mag, ri / mag


def _integer_peak(corr_abs: jnp.ndarray) -> jnp.ndarray:
    """Argmax of |ifft| unwrapped to signed shifts."""
    flat_idx = jnp.argmax(corr_abs)
    idx = jnp.unravel_index(flat_idx, corr_abs.shape)
    shape = jnp.asarray(corr_abs.shape)
    idx = jnp.stack(idx).astype(jnp.float32)
    return jnp.where(idx > shape // 2, idx - shape, idx)


def _upsampled_dft(
    cross_power_pair,
    shifts: jnp.ndarray,
    upsample_factor: int,
) -> jnp.ndarray:
    """Refine the peak on an upsampled local DFT grid (Guizar-Sicairos).

    The local inverse DFT around the coarse peak is a chain of small dense
    matmuls over the frequency axes; the complex kernel expands into
    cos/sin real matmuls on the (real, imag) pair. They run at HIGHEST
    precision: a TF32 product keeps about three decimal digits, too few
    for the sub-pixel peak the registration tests pin.
    """
    up = float(upsample_factor)
    region = int(np.ceil(up * 1.5))
    dftshift = region // 2

    dr, di = cross_power_pair
    ndim = dr.ndim
    # Contract one frequency axis at a time: result[r, ...] over region samples
    for axis in range(ndim):
        n = dr.shape[0]  # current leading axis (we roll axes as we go)
        freqs = jnp.asarray(spectrum_freqs(n))  # cycles/sample
        sample_pos = (
            jnp.arange(region, dtype=jnp.float32) - dftshift
        ) / up + shifts[axis]
        # kernel[r, f] = exp(2πi * freqs[f] * sample_pos[r]) — evaluates the
        # inverse DFT at arbitrary fractional sample positions
        angle = 2.0 * jnp.pi * sample_pos[:, None] * freqs[None, :]
        kr = jnp.cos(angle).astype(jnp.float32)
        ki = jnp.sin(angle).astype(jnp.float32)
        dot = partial(
            jnp.tensordot, axes=([1], [0]), precision=jax.lax.Precision.HIGHEST
        )
        nr = dot(kr, dr) - dot(ki, di)
        ni = dot(kr, di) + dot(ki, dr)
        # move the new region axis to the back so axis 0 is the next freq axis
        dr = jnp.moveaxis(nr, 0, -1)
        di = jnp.moveaxis(ni, 0, -1)
    # pair now has shape (region,)*ndim in axis order matching input
    local = jnp.sqrt(dr * dr + di * di)
    flat = jnp.argmax(local)
    loc = jnp.stack(jnp.unravel_index(flat, local.shape)).astype(jnp.float32)
    return shifts + (loc - dftshift) / up


def _roll_with_validity(
    moving: jnp.ndarray, shift: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Roll by the rounded shift and build the wrap-validity mask —
    shared by the NCC and SSIM candidate scorers (one definition so the
    validity predicate cannot drift between them)."""
    ishift = jnp.round(shift).astype(jnp.int32)
    rolled = moving
    mask = jnp.ones(moving.shape, jnp.float32)
    for ax in range(moving.ndim):
        rolled = jnp.roll(rolled, ishift[ax], axis=ax)
        n = moving.shape[ax]
        pos = jax.lax.broadcasted_iota(jnp.int32, moving.shape, ax)
        s = ishift[ax]
        valid = jnp.where(s >= 0, pos >= s, pos < n + s)
        mask = mask * valid.astype(jnp.float32)
    return rolled, mask


def _masked_ncc_for_shift(
    fixed: jnp.ndarray, moving: jnp.ndarray, shift: jnp.ndarray
) -> jnp.ndarray:
    """Normalized cross-correlation of the valid overlap after rolling
    ``moving`` by ``shift`` (static shapes: roll + validity mask)."""
    rolled, mask = _roll_with_validity(moving, shift)
    w = jnp.maximum(jnp.sum(mask), 1.0)
    fm = jnp.sum(fixed * mask) / w
    mm = jnp.sum(rolled * mask) / w
    fc = (fixed - fm) * mask
    mc = (rolled - mm) * mask
    denom = jnp.sqrt(jnp.sum(fc * fc) * jnp.sum(mc * mc))
    return jnp.sum(fc * mc) / jnp.maximum(denom, 1e-12)


@partial(jax.jit, static_argnames=("upsample_factor", "disambiguate"))
def phase_cross_correlation(
    fixed: jnp.ndarray,
    moving: jnp.ndarray,
    upsample_factor: int = 10,
    disambiguate: bool = True,
) -> jnp.ndarray:
    """Estimate the (push) translation aligning ``moving`` to ``fixed``.

    Returns float32 shifts, one per axis, subpixel-refined when
    ``upsample_factor > 1``.
    """
    fixed = fixed.astype(jnp.float32)
    moving = moving.astype(jnp.float32)
    R = _cross_power_spectrum(fixed, moving)
    cr, ci = ifftn_spec(*R)
    shift = _integer_peak(jnp.sqrt(cr * cr + ci * ci))

    if disambiguate:
        # all 2^d sign-wrap candidates: shift or shift -/+ size
        ndim = fixed.ndim
        shape = jnp.asarray(fixed.shape, jnp.float32)
        cands = []
        for bits in range(2**ndim):
            alt = []
            for ax in range(ndim):
                s = shift[ax]
                if (bits >> ax) & 1:
                    s = jnp.where(s >= 0, s - shape[ax], s + shape[ax])
                alt.append(s)
            cands.append(jnp.stack(alt))
        cands = jnp.stack(cands)  # (2^d, d)
        # lax.map (sequential): the 2^d rolled volumes + masks must not
        # coexist in HBM — a vmap here batches (2^d, z, y, x) buffers,
        # >10 GB on production fiducial overlaps (review r3; same
        # discipline as _score_candidates_batch below)
        nccs = jax.lax.map(
            lambda s: _masked_ncc_for_shift(fixed, moving, s), cands
        )
        shift = cands[jnp.argmax(nccs)]

    if upsample_factor > 1:
        shift = jnp.round(shift * upsample_factor) / upsample_factor
        shift = _upsampled_dft(R, shift, upsample_factor)
    return shift.astype(jnp.float32)


def _uniform_filter(x: jnp.ndarray, win: int) -> jnp.ndarray:
    """Separable uniform (box) filter, 'valid' region kept full-size with
    edge effects handled by cropping at the caller (skimage SSIM semantics)."""
    for ax in range(x.ndim):
        kernel = jnp.ones((win,), jnp.float32) / win
        shape = [1] * x.ndim
        shape[ax] = win
        x = jax.scipy.signal.convolve(x, kernel.reshape(shape), mode="same")
    return x


@partial(jax.jit, static_argnames=("win",))
def ssim(
    a: jnp.ndarray, b: jnp.ndarray, *, data_range: float = 1.0, win: int = 7
) -> jnp.ndarray:
    """Mean structural similarity (skimage defaults: uniform 7^d windows,
    K1=0.01, K2=0.03, sample covariance normalization), replacing
    `cucim.skimage.metrics.structural_similarity` in the stitching plugin
    (reference `multiview_registration.py:810-817`)."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    n = win**a.ndim
    cov_norm = n / (n - 1.0)
    ua = _uniform_filter(a, win)
    ub = _uniform_filter(b, win)
    uaa = _uniform_filter(a * a, win)
    ubb = _uniform_filter(b * b, win)
    uab = _uniform_filter(a * b, win)
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ua * ub + c1) * (2 * vab + c2)) / (
        (ua * ua + ub * ub + c1) * (va + vb + c2)
    )
    pad = (win - 1) // 2
    interior = s[tuple(slice(pad, dim - pad) for dim in s.shape)]
    return jnp.mean(interior)


@partial(jax.jit, static_argnames=("win",))
def _score_candidates_batch(
    fixed: jnp.ndarray,
    moving: jnp.ndarray,
    shifts: jnp.ndarray,  # (K, ndim) f32
    win: int = 7,
):
    """(ssim, overlap_fraction) for a BATCH of integer translation
    candidates in one program (sequential lax.map — K rolled volumes never
    coexist in HBM)."""

    def one(shift):
        s, frac, _ = _rolled_candidate_score(fixed, moving, shift, win)
        return s, frac

    return jax.lax.map(one, shifts)


@partial(jax.jit, static_argnames=("win",))
def _rolled_candidate_score(
    fixed: jnp.ndarray,
    moving: jnp.ndarray,
    shift: jnp.ndarray,
    win: int = 7,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(ssim, overlap_fraction, rolled+masked moving) for one integer
    translation candidate. The rolled image is zeroed outside validity, the
    SSIM is computed over the full frame — mirroring the reference plugin,
    which translates with NaN fill then scores ``nan_to_num`` images
    (`multiview_registration.py:766-817`)."""
    rolled, mask = _roll_with_validity(moving, shift)
    rolled = rolled * mask
    frac = jnp.sum(mask) / float(np.prod(fixed.shape))
    if win >= 3:
        score = ssim(fixed, rolled, win=win)
    else:
        # overlap too small for a 3^d SSIM window: fall back to masked NCC
        # (the reference marks such candidates unusable,
        # `multiview_registration.py:810-812`; NCC keeps tiny-tile tests
        # and extreme crops functional instead of rejecting everything)
        score = _masked_ncc_for_shift(fixed, moving, shift)
    return score, frac, rolled


@jax.jit
def _dual_normalization_peaks(
    fixed: jnp.ndarray, moving: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Integer correlation peaks under phase normalization and plain
    cross-correlation (the reference plugin tries both,
    `multiview_registration.py:701-711`). Also returns the
    phase-normalized cross-power pair so the subpixel refinement reuses
    it instead of paying two more full-volume forward FFTs per tile pair."""
    F = fftn_spec(fixed.astype(jnp.float32))
    M = fftn_spec(moving.astype(jnp.float32))
    rr, ri = c_mul(F, c_conj(M))
    mag = jnp.maximum(jnp.sqrt(rr * rr + ri * ri), 1e-20)
    nr, ni = rr / mag, ri / mag
    pr, pi = ifftn_spec(nr, ni)
    peak_phase = _integer_peak(jnp.sqrt(pr * pr + pi * pi))
    qr, qi = ifftn_spec(rr, ri)
    peak_plain = _integer_peak(jnp.sqrt(qr * qr + qi * qi))
    return peak_phase, peak_plain, nr, ni


@partial(jax.jit, static_argnames=("upsample_factor",))
def _refine_subpixel(
    rr: jnp.ndarray,
    ri: jnp.ndarray,
    shift: jnp.ndarray,
    *,
    upsample_factor: int,
) -> jnp.ndarray:
    """Upsampled-DFT refinement from a precomputed phase-normalized
    cross-power pair (the caller already built it for peak finding)."""
    return _upsampled_dft((rr, ri), shift, upsample_factor)


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation with average ranks (host-side; replaces the
    reference's custom CuPy rankdata, `multiview_registration.py:554-621`)."""
    from scipy.stats import spearmanr

    a = np.ravel(np.asarray(a, np.float64))
    b = np.ravel(np.asarray(b, np.float64))
    if a.size < 2 or np.ptp(a) == 0 or np.ptp(b) == 0:
        return float("nan")
    rho = spearmanr(a, b).statistic
    return float(rho)


def register_translation_with_quality(
    fixed,
    moving,
    *,
    upsample_factor: int = 2,
) -> tuple[np.ndarray, float]:
    """Pairwise translation registration with 4^d-candidate SSIM
    disambiguation and Spearman quality, the analog of the reference's
    multiview-stitcher plugin `cucim_phase_correlation_registration`
    (`multiview_registration.py:624-832`).

    Candidate set: integer peaks from both the phase-normalized and plain
    cross-power spectra, each expanded per axis into the wrap aliases
    {s, s±size} and their sign flips, filtered to range (≤4 live options
    per axis when s != 0). Each candidate is
    scored by SSIM of the fixed image vs the rolled/masked moving image;
    the winner's quality is the Spearman correlation over the valid overlap.

    Returns (shift_push, quality): ``shift_push`` rolls ``moving`` onto
    ``fixed`` (same convention as :func:`phase_cross_correlation`).
    """
    fixed = jnp.asarray(fixed, jnp.float32)
    moving = jnp.asarray(moving, jnp.float32)
    # rescale to [0,1] like the reference plugin (`:818-827` rescale_intensity)
    def _rescale(im):
        lo, hi = jnp.min(im), jnp.max(im)
        return (im - lo) / jnp.maximum(hi - lo, 1e-12)

    fixed = _rescale(fixed)
    moving = _rescale(moving)
    ndim = fixed.ndim
    shape = np.asarray(fixed.shape, np.float64)

    peak_phase, peak_plain, cross_rr, cross_ri = _dual_normalization_peaks(
        fixed, moving
    )
    base_shifts = [np.asarray(peak_phase), np.asarray(peak_plain)]

    # Wrap-alias expansion in PUSH convention: {s, s-size, s+size} are
    # the aliases of the measured wrap-around peak (whichever lands in
    # range — BOTH signs of s need an alias, review r3: with s < 0 the
    # true positive shift is s+size and listing only s-size made shifts
    # beyond half the overlap unrecoverable in one direction), plus the
    # sign flips {-s, size-s, -s-size}. Out-of-range options filter out,
    # leaving ≤4 live options per axis (the reference enumerates the
    # same set in the PULL convention of `affine_transform`,
    # `multiview_registration.py:735-751`).
    max_shift = float(max(fixed.shape))
    candidates: list[tuple[float, ...]] = []
    seen = set()
    for s_vec in base_shifts:
        opts_per_axis = []
        for d in range(ndim):
            s = float(s_vec[d])
            if s == 0:
                opts_per_axis.append([0.0])
            else:
                opts_per_axis.append(
                    [s, s - shape[d], s + shape[d],
                     -s, shape[d] - s, -s - shape[d]]
                )
        for combo in itertools.product(*opts_per_axis):
            if max(abs(c) for c in combo) >= max_shift:
                continue
            key = tuple(int(round(c)) for c in combo)
            if key in seen:
                continue
            seen.add(key)
            candidates.append(combo)

    if not candidates:
        return np.zeros(ndim, np.float32), 1.0

    # skimage-style window shrink for small volumes
    # (`multiview_registration.py:808-812`)
    min_shape = int(min(fixed.shape))
    win = min(7, min_shape - ((min_shape - 1) % 2))

    # ONE batched device program scores every candidate (the r2 host loop
    # dispatched each of up to ~128 candidates separately — per tile pair,
    # per round-trip; at the reference's 42-tile pairwise scale the
    # dispatch latency dominated). Candidates pad to power-of-two buckets
    # so shape buckets stay few across pairs.
    k = len(candidates)
    bucket = 1 << (k - 1).bit_length()
    cand_arr = np.zeros((bucket, ndim), np.float32)
    cand_arr[:k] = np.asarray(candidates, np.float32)
    scores_j, fracs_j = _score_candidates_batch(
        fixed, moving, jnp.asarray(cand_arr), win
    )
    scores_np = np.asarray(scores_j)[:k]
    fracs_np = np.asarray(fracs_j)[:k]
    scores_np = np.where(fracs_np >= 0.1, scores_np, -1.0)
    if not (scores_np > -1.0).any():
        # NO candidate has a usable overlap — the pair is unregistrable
        # (wrong adjacency metadata, blank tile). Returning an arbitrary
        # argmax-0 candidate with a tiny-overlap Spearman let garbage
        # through the quality gate (review r3); NaN quality marks the
        # pair unusable like the reference does.
        return np.zeros(ndim, np.float32), float("nan")
    best_idx = int(np.argmax(scores_np))

    winner = np.asarray(candidates[best_idx], np.float64)

    # quality = Spearman over the valid overlap of the winning candidate
    _, _, rolled = _rolled_candidate_score(
        fixed, moving, jnp.asarray(winner, jnp.float32), win
    )
    ov = overlap_slices_after_translation(fixed.shape, -winner)
    if ov is None:
        quality = float("nan")
    else:
        quality = _spearman(
            np.asarray(fixed)[ov], np.asarray(rolled)[ov]
        )

    # subpixel refinement around the winner on the phase-normalized
    # spectrum (reused from peak finding — no extra forward FFTs)
    if upsample_factor > 1:
        refined = _refine_subpixel(
            cross_rr,
            cross_ri,
            jnp.asarray(
                np.round(winner * upsample_factor) / upsample_factor, jnp.float32
            ),
            upsample_factor=upsample_factor,
        )
        winner = np.asarray(refined, np.float64)

    return winner.astype(np.float32), quality


def overlap_slices_after_translation(
    shape, translation_px
) -> tuple[slice, ...] | None:
    """Output slices whose translated coordinates stay inside the input
    (reference `multiview_registration.py:83-113`). Host-side helper."""
    slices = []
    for axis_size, t in zip(shape, translation_px):
        start = int(np.ceil(max(0.0, -float(t))))
        stop = int(np.floor(min(float(axis_size), float(axis_size) - float(t))))
        if stop <= start:
            return None
        slices.append(slice(start, stop))
    return tuple(slices)
