"""Per-pixel MERFISH nearest-codeword decoding as one matmul.

JAX replacement for the reference decode hot loop
(`PixelDecoder._decode_pixels:2148-2264`, `_scale_pixel_traces:1976-2024`,
`_normalize_pixel_traces:2058-2092`, `_calculate_distances:2094-2146` which
uses cuVS ``pairwise_distance`` + argmin):

Both pixel traces and codewords are L2-normalized, so the Euclidean
nearest codeword reduces to ``argmax(t · c)`` with
``min_dist = sqrt(2 - 2 max(t · c))`` — a single (pixels × bits) @
(bits × codewords) matmul plus a row max/argmax. The scale→clip→normalize
prologue fuses into the matmul, as cuVS's expanded-distance GEMM does for
the reference.

The volume API (:func:`decode_volume`) processes a z-chunked
``(bits, Z, Y, X)`` stack and returns the decoded codeword index (int16,
-1 = unassigned), trace magnitude (f16), distance (f16) and scaled traces
(f16) exactly as the reference stores them (`PixelDecoder.py:2167-2175`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

def normalize_codebook(codebook_matrix: np.ndarray) -> np.ndarray:
    """L2-normalize codeword rows (reference `_normalize_codebook:585-639`)."""
    cb = np.asarray(codebook_matrix, dtype=np.float32)
    norm = np.linalg.norm(cb, axis=1, keepdims=True)
    return cb / np.maximum(norm, 1e-12)


def caller_thresholds(on_bits_median: int) -> tuple[float, float]:
    """Exact two-threshold MERFISH caller constants from the median on-bit
    count B (reference `PixelDecoder._load_codebook:561-574`).

    Returns (pixel_assignment_threshold, transcript_distance_threshold).
    """
    b = float(on_bits_median)
    pixel = np.sqrt(2.0 - 2.0 * (b - 2.0) / np.sqrt(b * (b - 2.0)))
    transcript = np.sqrt(2.0 - 2.0 * b / np.sqrt(b * (b + 2.0)))
    return float(pixel), float(transcript)


def _scale_clip_normalize(traces, background, normalization):
    """(t - bg)/norm → clip [0,1] → L2 normalize; returns (unit, magnitude,
    scaled) (reference `:1976-2092`).

    Layout: ``traces`` is **(bits, N)**: the planes of a ``(bits, Z, Y, X)``
    stack flatten to it with no copy and no transpose.
    """
    scaled = (traces - background[:, None]) / normalization[:, None]
    scaled = jnp.clip(scaled, 0.0, 1.0)
    mag = jnp.sqrt(jnp.sum(scaled * scaled, axis=0))
    unit = scaled / jnp.maximum(mag, 1e-12)[None, :]
    return unit, mag, scaled


def _decode_chunk(traces, codebook_t, background, normalization):
    """traces: (bits, N) f32; codebook_t: (bits, words) L2-normalized.

    The dot runs at HIGHEST precision: a float32 matmul may otherwise run
    in TF32 (about three decimal digits), which moves argmax ties and the
    distance threshold. K is the bit count, so the cost is nil."""
    unit, mag, scaled = _scale_clip_normalize(traces, background, normalization)
    sims = jnp.dot(
        codebook_t.T, unit, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    best = jnp.argmax(sims, axis=0).astype(jnp.int32)
    max_sim = jnp.max(sims, axis=0)
    dist = jnp.sqrt(jnp.maximum(2.0 - 2.0 * max_sim, 0.0))
    return best, dist, mag, scaled


@partial(
    jax.jit,
    static_argnames=("magnitude_threshold", "distance_threshold"),
)
def decode_planes(
    bit_planes: jnp.ndarray,  # (bits, P, Y, X) float32 (already lowpassed/warped)
    codebook_t: jnp.ndarray,  # (bits, words) normalized
    background: jnp.ndarray,  # (bits,)
    normalization: jnp.ndarray,  # (bits,)
    *,
    magnitude_threshold: tuple[float, float] = (1.5, 10.0),
    distance_threshold: float = 0.5172,
):
    """Decode a block of z-planes. Returns (decoded int16 [-1 unassigned],
    magnitude f16, distance f16, scaled f16) shaped like the spatial dims
    (reference `_decode_pixels:2148-2264`)."""
    bits, p, ny, nx = bit_planes.shape
    traces = bit_planes.reshape(bits, -1)  # (bits, N): contiguous, no copy
    best, dist, mag, scaled = _decode_chunk(
        traces, codebook_t, background, normalization
    )
    lo, hi = magnitude_threshold
    assigned = (dist <= distance_threshold) & (mag >= lo) & (mag <= hi)
    decoded = jnp.where(assigned, best, -1).astype(jnp.int16)
    return (
        decoded.reshape(p, ny, nx),
        mag.astype(jnp.float16).reshape(p, ny, nx),
        dist.astype(jnp.float16).reshape(p, ny, nx),
        scaled.astype(jnp.float16).reshape(bits, p, ny, nx),
    )


def decode_volume(
    bit_volume: np.ndarray,  # (bits, Z, Y, X)
    codebook_matrix: np.ndarray,  # (words, bits) raw 0/1
    background: np.ndarray,
    normalization: np.ndarray,
    *,
    magnitude_threshold: tuple[float, float] = (1.5, 10.0),
    distance_threshold: float,
    z_chunk: int = 8,
    return_scaled: bool = True,
):
    """Decode a full tile volume in z-chunks (bounding device memory to
    ``bits × z_chunk × Y × X``, the analog of the reference per-z-plane
    loop `PixelDecoder.py:2187-2253`).

    ``return_scaled=False`` skips materializing + reading back the
    ``(bits, Z, Y, X)`` scaled-trace array (the normalization-optimization
    path discards it — review r3: ~bits× the volume of wasted device→host
    transfer per tile per iteration)."""
    cb_t = jnp.asarray(normalize_codebook(codebook_matrix).T)
    bg = jnp.asarray(background, jnp.float32)
    norm = jnp.asarray(normalization, jnp.float32)
    bits, nz, ny, nx = bit_volume.shape

    decoded = np.empty((nz, ny, nx), np.int16)
    mag = np.empty((nz, ny, nx), np.float16)
    dist = np.empty((nz, ny, nx), np.float16)
    scaled = (
        np.empty((bits, nz, ny, nx), np.float16) if return_scaled else None
    )
    for z0 in range(0, nz, z_chunk):
        z1 = min(z0 + z_chunk, nz)
        p = z1 - z0
        block = jnp.asarray(bit_volume[:, z0:z1], jnp.float32)
        if p < z_chunk:  # pad to the static chunk size to avoid recompiles
            block = jnp.pad(block, ((0, 0), (0, z_chunk - p), (0, 0), (0, 0)))
        d, m, di, sc = decode_planes(
            block,
            cb_t,
            bg,
            norm,
            magnitude_threshold=tuple(magnitude_threshold),
            distance_threshold=float(distance_threshold),
        )
        decoded[z0:z1] = np.asarray(d)[:p]
        mag[z0:z1] = np.asarray(m)[:p]
        dist[z0:z1] = np.asarray(di)[:p]
        if scaled is not None:
            scaled[:, z0:z1] = np.asarray(sc)[:, :p]
    return decoded, mag, dist, scaled
