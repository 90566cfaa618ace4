"""qi2lab-fuse: fuse registered tiles into the global frame
(mirrors `cli/qi2lab_microscopes/fuseall.py:1-254`: per-channel fusion of
the fiducial plus every readout bit through the stored transforms).

Each readout bit is warped into the round-1 local reference frame through
the composed decode warp (round affine ∘ chromatic⁻¹, + SOFIMA flow when
stored — `utils/decode_warping.py`) and through the camera-to-stage pixel
affine (`DataRegistration.py:1466-1561` attaches it to every msim), then
stream-fused chunk-by-chunk into a (C, Z, Y, X) global OME-Zarr with host
memory bounded by one fusion chunk plus a small tile cache.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def fuse_all_channels(
    datastore,
    verbose: int = 1,
    *,
    chunk_px: int = 512,
    overlap_px: int = 64,
    tile_cache_tiles: int = 4,
) -> None:
    """Fuse the fiducial plus every readout bit into a (C, Z, Y, X) global
    volume using the stored per-tile global transforms, decode warps, and
    camera-to-stage affines."""
    from ...pipeline.decode_warping import warp_bit_image_to_reference
    from ...pipeline.stitching import (
        _TileCache,
        _apply_camera_affine,
        _camera_affine_px,
        _global_layout,
        _load_fiducial,
        stream_fuse,
    )

    ds = datastore
    spacing = np.asarray(ds.voxel_size_zyx_um, dtype=np.float64)
    n_tiles = len(ds.tile_ids)
    n_bits = ds.num_bits

    _, starts, shape_px, lo, out_shape = _global_layout(ds, n_tiles, spacing)

    out = ds.create_global_fused_image(
        (1 + n_bits, *(int(v) for v in out_shape)),
        np.uint16,
        affine_zyx_um=np.eye(4),
        origin_zyx_um=lo,
        spacing_zyx_um=spacing,
        all_channels=True,
    )

    def _bit_loader(bit_idx: int):
        def _load(t: int):
            img = ds.load_local_registered_image(tile=t, bit=bit_idx)
            if img is None:
                return None
            wl = ds.load_local_wavelengths_um(t, bit=bit_idx)
            emission_um = wl[1] if wl is not None else 0.0
            # decode warp: native bit → round-1 reference frame
            # (round affine ∘ chromatic⁻¹ + flow, single resample)
            warped = warp_bit_image_to_reference(
                np.asarray(img, np.float32),
                datastore=ds,
                tile=t,
                bit_id=ds.bit_ids[bit_idx],
                emission_wavelength_um=emission_um,
            )
            return _apply_camera_affine(warped, _camera_affine_px(ds, t))

        return _load

    def _fiducial_loader(t: int):
        return _apply_camera_affine(_load_fiducial(ds, t), _camera_affine_px(ds, t))

    for c in range(1 + n_bits):
        loader = _fiducial_loader if c == 0 else _bit_loader(c - 1)
        stream_fuse(
            _Channel(out, c),
            out_shape=out_shape,
            tile_starts_px=starts,
            tile_shape_px=shape_px,
            tile_cache=_TileCache(loader, tile_cache_tiles),
            chunk_px=chunk_px,
            feather_px=overlap_px,
        )
        if verbose:
            print(f"fused channel {c}/{n_bits}")


class _Channel:
    """Writable channel ``c`` of the (C, z, y, x) fused array."""

    def __init__(self, array, c: int):
        self._array, self._c = array, c

    def __setitem__(self, key, value) -> None:
        self._array[(self._c, *key)] = value


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qi2lab-fuse")
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--fiducial-only", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--chunk-px", type=int, default=512)
    p.add_argument("--overlap-px", type=int, default=64)
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from ...datastore import qi2labDataStore
    from ...pipeline.stitching import fuse_global_registered

    ds = qi2labDataStore(args.datastore_path, validate=False)
    fuse_global_registered(ds)
    if not args.fiducial_only:
        fuse_all_channels(ds, chunk_px=args.chunk_px, overlap_px=args.overlap_px)


if __name__ == "__main__":
    main()
