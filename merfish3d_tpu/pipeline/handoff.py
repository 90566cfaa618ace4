"""Device-resident register→decode handoff.

When registration and decoding run in one process (the fused production
path, and the common CLI sequence `preprocess` → `decode` driven from one
driver), the per-bit intermediates — deconvolved readout volumes and
U-FISH probability maps — never need to leave HBM: registration ``put``s
them here as it finishes each bit chunk, and the decoder consumes them
instead of re-reading zarr and re-uploading a full float32 stack: a
full HBM↔host bounce per tile (~270 MB each way at (16, 512, 512)) that
the fused path removes.

The cache is a FAST PATH, not a replacement for the on-disk contract:
persistence to the datastore still happens (write-behind — see
``DataRegistration(persist="deferred")``), and the decoder falls back to
the zarr read whenever a tile/bit is absent. Exactness: the cache stores
the decon volume as the SAME uint16 values the datastore persists and
the probability map as the SAME k/255 uint8 quantization the datastore
persists, so the cached decode input is bit-identical to the disk path's
(both compute u16→f32 × (u8→f32 / 255) in f32). Pinned by
`tests/test_handoff.py`.

Reference contrast: the reference's stages communicate ONLY through the
datastore (`DataRegistration.py:461`, `PixelDecoder.py:263` re-open it
per worker process) — a GPU→disk→GPU bounce per tile that its week-long
wall-clocks include. Here the stage boundary stays on the device.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp


@jax.jit
def _to_cache_forms(decons_f32, probs):
    """(decon f32, prob) → (decon u16, prob u8) — the persisted forms.

    Probabilities quantize to k/255 at this single boundary so every
    consumer (device cache, zarr, host and device decode paths, spot tables)
    sees the SAME values: u8 is a quarter of f32 on the ~15 MB/s
    device→host link and the single-core compressor, the two measured
    bottlenecks of the warm per-tile wall (BENCH r4 profile). jnp.round
    ties-to-even matches numpy's round in the datastore's host-side
    quantizer."""
    du = jnp.clip(decons_f32, 0.0, 65535.0).astype(jnp.uint16)
    pu = jnp.clip(
        jnp.round(probs.astype(jnp.float32) * 255.0), 0.0, 255.0
    ).astype(jnp.uint8)
    return du, pu


@jax.jit
def _product_f32(decon_u16, prob_u8):
    """Decode input: decon × (prob/255) in f32 — bit-identical to the
    host path's numpy ``u16.astype(f32) * (u8.astype(f32)/255)``."""
    return decon_u16.astype(jnp.float32) * (
        prob_u8.astype(jnp.float32) / jnp.float32(255.0)
    )


class TileDeviceCache:
    """Bounded per-tile store of device-resident (decon u16, prob u8)
    readout-bit chunks.

    Thread safe (registration's writer thread puts, the decode thread
    gets). ``max_tiles`` bounds HBM: one 16-bit × (16, 512, 512) tile is
    ~150 MB in cached form.
    """

    def __init__(self, max_tiles: int = 2):
        self._max_tiles = max(1, int(max_tiles))
        self._tiles: dict[int, dict[int, tuple]] = {}
        self._order: list[int] = []
        self._lock = threading.Lock()

    def put_chunk(self, tile_idx: int, bit_indices, decons_f32, probs) -> tuple:
        """Cache one registration chunk; returns the (u16, u8) device
        forms so the caller can derive its persistence transfer from the
        same arrays (single cast program)."""
        du, pf = _to_cache_forms(decons_f32, probs)
        with self._lock:
            tile = self._tiles.setdefault(int(tile_idx), {})
            for i, bit_idx in enumerate(bit_indices):
                tile[int(bit_idx)] = (du[i], pf[i])
            if int(tile_idx) in self._order:
                self._order.remove(int(tile_idx))
            self._order.append(int(tile_idx))
            while len(self._order) > self._max_tiles:
                evict = self._order.pop(0)
                self._tiles.pop(evict, None)
        return du, pf

    def put_persisted(self, tile_idx: int, bit_indices, decon_u16, prob_u8) -> None:
        """Populate the cache from the PERSISTED forms (zarr u16 decon +
        u8 probability): one u16+u8 upload per bit instead of a f32
        product upload per decode pass. Used by the decoder's
        cache-miss recovery — a resumed run skips registration, so the
        cache starts empty while every normalization-optimizer pass wants
        the same tile stacks."""
        du = jnp.asarray(np.ascontiguousarray(decon_u16))
        pu = jnp.asarray(np.ascontiguousarray(prob_u8))
        with self._lock:
            tile = self._tiles.setdefault(int(tile_idx), {})
            for i, bit_idx in enumerate(bit_indices):
                tile[int(bit_idx)] = (du[i], pu[i])
            if int(tile_idx) in self._order:
                self._order.remove(int(tile_idx))
            self._order.append(int(tile_idx))
            while len(self._order) > self._max_tiles:
                evict = self._order.pop(0)
                self._tiles.pop(evict, None)

    def has_bits(self, tile_idx: int, bit_indices) -> bool:
        with self._lock:
            tile = self._tiles.get(int(tile_idx))
            return tile is not None and all(int(b) in tile for b in bit_indices)

    def product_stack(self, tile_idx: int, bit_indices) -> Optional[jax.Array]:
        """(B, z, y, x) float32 device stack of decon × probability for
        the requested bits, or None on a miss."""
        with self._lock:
            tile = self._tiles.get(int(tile_idx))
            if tile is None or any(int(b) not in tile for b in bit_indices):
                return None
            pairs = [tile[int(b)] for b in bit_indices]
        du = jnp.stack([p[0] for p in pairs])
        pf = jnp.stack([p[1] for p in pairs])
        return _product_f32(du, pf)

    def evict(self, tile_idx: Optional[int] = None) -> None:
        with self._lock:
            if tile_idx is None:
                self._tiles.clear()
                self._order.clear()
            else:
                self._tiles.pop(int(tile_idx), None)
                if int(tile_idx) in self._order:
                    self._order.remove(int(tile_idx))
