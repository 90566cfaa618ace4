"""Device mesh + sharded pipeline steps.

Replacement for the reference's process-per-GPU distribution
(SURVEY.md §2.9): instead of spawning one OS process per device and
partitioning tiles/rounds/bits statically
(`PixelDecoder.decode_all_tiles:4363-4392`,
`DataRegistration._generate_registrations:2156-2173`), one process lays a
``jax.sharding.Mesh`` over the cards with axes ``(tile, z)``:

- **tile axis** — data parallelism over tiles/bits (the dominant axis),
- **z axis** — spatial domain decomposition inside one volume when a tile
  exceeds a card's memory; XLA inserts the halo exchanges for the z-blurred
  convolutions automatically (GSPMD), replacing the reference's
  recompute-halo tiling (`rlgc.py:908-1020`).

Cross-device reductions (per-bit normalization statistics) are ``psum``
collectives, which XLA hands to NCCL on the GPU — replacing the reference's temp-parquet gather
(`PixelDecoder._save_barcodes:2785-2791`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_tile_shards: int | None = None, n_z_shards: int = 1, devices=None
) -> Mesh:
    """Build a (tile, z) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_tile_shards is None:
        n_tile_shards = n // n_z_shards
    assert n_tile_shards * n_z_shards <= n
    grid = np.asarray(devices[: n_tile_shards * n_z_shards]).reshape(
        n_tile_shards, n_z_shards
    )
    return Mesh(grid, axis_names=("tile", "z"))


def _gaussian_kernel(sigma: float) -> jnp.ndarray:
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray((k / k.sum()).astype(np.float32))


def _blur_axis(vol: jnp.ndarray, kernel: jnp.ndarray, axis: int) -> jnp.ndarray:
    """1D convolution along one axis of an N-D array, SAME padding.

    Uses lax.conv_general_dilated whose spatial halo on sharded axes is
    handled by GSPMD collectives.
    """
    moved = jnp.moveaxis(vol, axis, -1)
    lead = moved.shape[:-1]
    flat = moved.reshape(-1, 1, moved.shape[-1])  # (batch, C=1, W)
    out = jax.lax.conv_general_dilated(
        flat,
        kernel[None, None, :],
        window_strides=(1,),
        padding="SAME",
        dimension_numbers=("NCH", "OIH", "NCH"),
    )
    out = out.reshape(*lead, -1)
    return jnp.moveaxis(out, -1, axis)


def decode_pipeline_step(
    tiles: jnp.ndarray,  # (T, bits, Z, Y, X) float32
    codebook_t: jnp.ndarray,  # (bits, words) L2-normalized
    background: jnp.ndarray,  # (bits,)
    normalization: jnp.ndarray,  # (bits,)
    *,
    sigma=(3.0, 1.0, 1.0),
    magnitude_threshold=(1.5, 10.0),
    distance_threshold: float = 0.5172,
):
    """One full sharded decode step over a batch of tiles: Gaussian lowpass
    (z-sharded conv → GSPMD halo exchange) → scale/clip/normalize →
    nearest-codeword matmul → assignment masks → per-bit statistics reduced
    across the mesh (the normalization-update reduction).

    Shard-friendly formulation: bits live on the trailing contraction axis
    (no flatten across sharded spatial dims).
    """
    x = tiles
    for ax, s in zip((2, 3, 4), sigma):
        if s and s > 0:
            x = _blur_axis(x, _gaussian_kernel(float(s)), ax)
    # (T, Z, Y, X, bits)
    x = jnp.moveaxis(x, 1, -1)
    scaled = jnp.clip((x - background) / normalization, 0.0, 1.0)
    mag = jnp.sqrt(jnp.sum(scaled * scaled, axis=-1))
    unit = scaled / jnp.maximum(mag, 1e-12)[..., None]
    # HIGHEST: a float32 einsum may otherwise run in TF32 and move argmax
    # ties; K is the bit count, so the cost is nil
    sims = jnp.einsum(
        "...b,bw->...w", unit, codebook_t, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    best = jnp.argmax(sims, axis=-1).astype(jnp.int16)
    dist = jnp.sqrt(jnp.maximum(2.0 - 2.0 * jnp.max(sims, axis=-1), 0.0))
    lo, hi = magnitude_threshold
    assigned = (dist <= distance_threshold) & (mag >= lo) & (mag <= hi)
    decoded = jnp.where(assigned, best, -1)

    # per-bit statistics over assigned voxels — reduces across the full
    # mesh (tile AND z shards): XLA emits the psum
    w = assigned[..., None].astype(jnp.float32)
    bit_sums = jnp.sum(scaled * w, axis=(0, 1, 2, 3))
    counts = jnp.maximum(jnp.sum(w, axis=(0, 1, 2, 3)), 1.0)
    bit_stats = bit_sums / counts
    return decoded, dist.astype(jnp.float16), mag.astype(jnp.float16), bit_stats


def make_sharded_decode_step(mesh: Mesh, **kwargs):
    """jit `decode_pipeline_step` with (tile, z) shardings over the mesh."""
    tile_sharding = NamedSharding(mesh, P("tile", None, "z", None, None))
    repl = NamedSharding(mesh, P())
    fn = partial(decode_pipeline_step, **kwargs)
    return jax.jit(
        fn,
        in_shardings=(tile_sharding, repl, repl, repl),
        out_shardings=(
            NamedSharding(mesh, P("tile", "z", None, None)),
            NamedSharding(mesh, P("tile", "z", None, None)),
            NamedSharding(mesh, P("tile", "z", None, None)),
            repl,
        ),
    )


# --------------------------------------------------------------------------
# Production tile-sharded decode (used by PixelDecoder.decode_all_tiles)
# --------------------------------------------------------------------------

def make_tile_mesh(n_tiles: int | None = None, devices=None) -> Mesh:
    """1-D ``("tile",)`` mesh: one tile volume per chip, the dominant data
    parallelism (reference `decode_tiles_worker:208-310` partitions tiles
    statically across GPU worker processes)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices) if n_tiles is None else min(n_tiles, len(devices))
    return Mesh(np.asarray(devices[:n]), axis_names=("tile",))


def make_sharded_tile_decoder(
    mesh: Mesh,
    *,
    sigma=(3.0, 1.0, 1.0),
    magnitude_threshold=(1.5, 10.0),
    distance_threshold: float,
    return_lowpassed: bool = False,
):
    """Cached wrapper: one compiled step per (mesh, config)."""
    return _make_sharded_tile_decoder_cached(
        mesh,
        tuple(float(s) for s in sigma),
        tuple(float(v) for v in magnitude_threshold),
        float(distance_threshold),
        bool(return_lowpassed),
    )


from functools import lru_cache


@lru_cache(maxsize=32)
def _make_sharded_tile_decoder_cached(
    mesh: Mesh,
    sigma: tuple,
    magnitude_threshold: tuple,
    distance_threshold: float,
    return_lowpassed: bool,
):
    """Build the jitted production decode step over a batch of tiles.

    Semantics are EXACTLY the single-device path
    (:func:`merfish3d_tpu.ops.filters.gaussian_lowpass` →
    :func:`merfish3d_tpu.ops.decode._decode_chunk` + thresholds):
    `shard_map` hands each device its own whole tiles, so the per-tile
    numerics are bit-identical to a 1-device run — the CPU determinism
    test asserts this. Replaces the reference's per-GPU worker processes
    (`PixelDecoder.decode_all_tiles:4363-4392`).

    Input: ``tiles (T, bits, Z, Y, X)`` with T divisible by the mesh size.
    Returns ``(decoded int16 (T,Z,Y,X), mag f16, dist f16,
    intensity f16 (T,bits,Z,Y,X))`` where intensity is the lowpassed
    volume when ``return_lowpassed`` (normalization-optimization decodes,
    reference `PixelDecoder.py:2503-2510`) else the scaled traces.
    """
    from jax import shard_map

    from ..ops.decode import _decode_chunk
    from ..ops.filters import gaussian_lowpass

    sigma = tuple(float(s) for s in sigma)
    lo, hi = (float(v) for v in magnitude_threshold)
    thr = float(distance_threshold)

    def _one(vol, cb_t, bg, norm):  # vol: (bits, Z, Y, X)
        bits, nz, ny, nx = vol.shape
        lp = (
            gaussian_lowpass(vol, sigma=sigma)
            if any(s > 0 for s in sigma)
            else vol.astype(jnp.float32)
        )
        best, dist, mag, scaled = _decode_chunk(
            lp.reshape(bits, -1), cb_t, bg, norm
        )
        assigned = (dist <= thr) & (mag >= lo) & (mag <= hi)
        decoded = jnp.where(assigned, best, -1).astype(jnp.int16)
        # per-bit foreground statistics (sum of scaled trace over assigned
        # voxels, assigned count): the optimizer's device-side convergence
        # diagnostic, psum-reduced across the tile mesh axis below —
        # the collective replacement for the reference's temp-parquet gather
        # (`_save_barcodes:2785-2791`; exact medians stay host-side)
        w = assigned.astype(jnp.float32)[None, :]
        stats = jnp.stack(
            [jnp.sum(scaled * w, axis=1), jnp.sum(w, axis=1)[0] * jnp.ones(bits)]
        )
        if return_lowpassed:
            # raw lowpassed intensities feed the normalization medians —
            # keep f32 (the single-device path never rounds them to f16)
            intensity = lp.astype(jnp.float32)
        else:
            intensity = scaled.astype(jnp.float16).reshape(vol.shape)
        return (
            decoded.reshape(nz, ny, nx),
            mag.astype(jnp.float16).reshape(nz, ny, nx),
            dist.astype(jnp.float16).reshape(nz, ny, nx),
            intensity,
            stats,
        )

    def _block(tiles, cb_t, bg, norm):  # (T_local, bits, Z, Y, X)
        decoded, mag, dist, intensity, stats = jax.vmap(
            _one, in_axes=(0, None, None, None)
        )(tiles, cb_t, bg, norm)
        # cross-device reduction over the tile axis (XLA emits the psum);
        # replicated (2, bits) result
        bit_stats = jax.lax.psum(jnp.sum(stats, axis=0), "tile")
        return decoded, mag, dist, intensity, bit_stats

    sharded = shard_map(
        _block,
        mesh=mesh,
        in_specs=(P("tile"), P(), P(), P()),
        out_specs=(P("tile"), P("tile"), P("tile"), P("tile"), P()),
    )
    return jax.jit(sharded)


def put_tiles_sharded(mesh: Mesh, tiles: np.ndarray):
    """Transfer a (T, ...) host batch with the leading axis sharded over the
    tile mesh axis (each card receives only its own tiles)."""
    spec = P(*(("tile",) + (None,) * (tiles.ndim - 1)))
    return jax.device_put(tiles, NamedSharding(mesh, spec))
