"""Global tile registration + streamed fusion.

Own implementation replacing multiview-stitcher + dask + cupy fusion
(reference `DataRegistration.global_register:1839-2006` /
`_fuse_global_registered_msims:1650-1837`, SURVEY.md §2.8):

1. overlap graph from stage positions, pruned to axis-aligned neighbor
   pairs when ``keep_axis_aligned`` (reference
   ``pre_registration_pruning_method="keep_axis_aligned"``,
   `DataRegistration.py:79`),
2. pairwise translation registration on ``binning_zyx``-binned overlap
   regions with 4^d-candidate SSIM disambiguation and Spearman quality
   (the `cucim_phase_correlation_registration` plugin analog,
   `multiview_registration.py:624-832`), pairs below ``quality_threshold``
   dropped (reference ``post_registration_do_quality_filter``),
3. quality-weighted least-squares resolution of per-tile global
   translations (anchor = tile 0; ``transform_type="translation"``),
4. chunked, feathered weighted-average fusion streamed directly into the
   fused OME-Zarr — host memory stays bounded by one fusion chunk plus a
   small tile cache, never the global bounding box (reference fuses
   512-px chunks with 64-px overlap straight to zarr,
   `DataRegistration.py:1728-1743`, `GlobalFusionConfig:98-109`).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from ..datastore import zarrio
from ..ops.filters import downsample_image_anisotropic
from ..ops.phase_corr import register_translation_with_quality
from ..ops.warp import warp_affine
from ..utils.cache import LoaderCache


def _mv_diag(enabled: bool, stage: str, **fields) -> None:
    """Structured `[multiview-registration]` diagnostics channel
    (reference `multiview_registration.py:13-31`): timestamped lines with
    shapes/shift/quality/elapsed per pairwise registration and fusion
    geometry."""
    if not enabled:
        return
    import time as _time

    ts = _time.strftime("%Y-%m-%d %H:%M:%S")
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[multiview-registration] {ts} stage={stage} {kv}", flush=True)


def _tile_origin_um(datastore, tile_idx) -> np.ndarray:
    stage = datastore.load_local_stage_position_zyx_um(tile_idx, round=0)
    if stage is None:
        return np.zeros(3)
    return np.asarray(stage[0], dtype=np.float64)


def _camera_affine_px(datastore, tile_idx) -> np.ndarray:
    stage = datastore.load_local_stage_position_zyx_um(tile_idx, round=0)
    if stage is None:
        return np.eye(4)
    return np.asarray(stage[1], dtype=np.float64)


def _load_fiducial(datastore, tile_idx) -> np.ndarray:
    img = datastore.load_local_registered_image(tile=tile_idx, round=0)
    if img is None:
        img = datastore.load_local_corrected_image(tile=tile_idx, round=0)
    if img is None:
        # np.asarray(None) would yield a 0-d NaN that crashes far
        # downstream (review r3) — fail loudly at the source instead
        raise FileNotFoundError(
            f"tile {tile_idx}: no registered or corrected round-0 "
            "fiducial image in the datastore (run preprocessing first)"
        )
    return np.asarray(img, np.float32)


def _apply_camera_affine(img: np.ndarray, affine_px: np.ndarray) -> np.ndarray:
    """Resample a tile through its camera-to-stage pixel affine so fusion
    sees stage-aligned tiles (the reference attaches ``affine_zyx_px`` to
    each msim before registration/fusion, `DataRegistration.py:1466-1561`).

    ``affine_px`` maps camera px → stage px (moving → reference); the warp
    convention wants reference → moving, hence the inverse. Identity is the
    overwhelmingly common case and short-circuits.
    """
    if np.allclose(affine_px, np.eye(4)):
        return img
    return warp_affine(
        img,
        transform_zyx_um=np.linalg.inv(affine_px),
        spacing_zyx_um=(1.0, 1.0, 1.0),
        reference_shape=img.shape,
    ).astype(np.float32, copy=False)


_SIZE_LADDER = [4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                768, 1024, 1536, 2048, 3072, 4096]


def _bucket_size(n: int) -> int:
    """Largest ladder size <= n (0 when n < 4): compile-variant control
    for the shape-specialized pairwise-registration programs."""
    b = 0
    for s in _SIZE_LADDER:
        if s <= n:
            b = s
        else:
            break
    return b


def _overlap_bounds(o_i, o_j, shape_px, spacing):
    """Pixel bounds of the overlap box in each tile's frame, or None."""
    size_um = np.asarray(shape_px) * spacing
    lo = np.maximum(o_i, o_j)
    hi = np.minimum(o_i + size_um, o_j + size_um)
    if np.any(hi - lo <= spacing * 4):
        return None
    lo_i = np.floor((lo - o_i) / spacing).astype(int)
    hi_i = np.ceil((hi - o_i) / spacing).astype(int)
    lo_j = np.floor((lo - o_j) / spacing).astype(int)
    hi_j = np.ceil((hi - o_j) / spacing).astype(int)
    return (lo_i, hi_i), (lo_j, hi_j)


def _is_axis_aligned_pair(o_i, o_j, size_um, frac: float = 0.1) -> bool:
    """True when the pair is adjacent along exactly one axis: the stage
    offset is significant (>``frac`` of the tile extent) in at most one
    axis. Diagonal grid neighbors are pruned, matching multiview-stitcher's
    ``keep_axis_aligned`` pre-registration pruning."""
    offset = np.abs(np.asarray(o_j) - np.asarray(o_i))
    significant = offset > frac * np.asarray(size_um)
    return int(np.sum(significant)) <= 1


def global_register(
    datastore, *, config=None, fusion_config=None, verbose=1, devices=None
):
    """Estimate + save per-tile global coordinate transforms, then fuse.

    Honors every `GlobalRegistrationConfig` field: volumes are binned by
    ``binning_zyx`` before pairwise registration, non-axis-aligned pairs
    are pruned when ``keep_axis_aligned``, and pairs whose Spearman quality
    falls below ``quality_threshold`` are dropped from the least-squares
    resolution (reference `DataRegistration.py:71-95`,
    `multiview_registration.py:554-832`).

    ``devices``: explicit device list for the pairwise-registration
    fan-out (default: all visible devices). Each pair computes wholly on
    one device, so results are device-count invariant.
    """
    ds = datastore
    n_tiles = len(ds.tile_ids)
    spacing = np.asarray(ds.voxel_size_zyx_um, dtype=np.float64)
    binning = np.asarray(
        getattr(config, "binning_zyx", (3, 6, 6)) if config else (3, 6, 6), int
    )
    keep_axis_aligned = getattr(config, "keep_axis_aligned", True) if config else True
    quality_threshold = getattr(config, "quality_threshold", 0.2) if config else 0.2
    diagnostics = bool(getattr(config, "diagnostics", False)) if config else False
    _mv_diag(
        diagnostics,
        "start",
        n_tiles=n_tiles,
        binning=tuple(int(v) for v in binning),
        keep_axis_aligned=keep_axis_aligned,
        quality_threshold=quality_threshold,
    )

    if n_tiles == 1:
        # single-tile shortcut: identity transform (reference `:1877-1893`)
        origin = _tile_origin_um(ds, 0)
        ds.save_global_coord_xforms_um(
            0, affine_zyx_um=np.eye(4), origin_zyx_um=origin, spacing_zyx_um=spacing
        )
        fuse_global_registered(ds, config=fusion_config, verbose=verbose)
        return

    origins = [_tile_origin_um(ds, t) for t in range(n_tiles)]

    # Load tiles ONE at a time and keep only the binned copies (a (3,6,6)
    # binning shrinks them ~100x) — never all full-res tiles in host RAM
    # (reference registers on binned msims, `registration_binning`).
    binned: list[np.ndarray] = []
    shape_px: Optional[tuple[int, ...]] = None
    for t in range(n_tiles):
        img = _load_fiducial(ds, t)
        img = _apply_camera_affine(img, _camera_affine_px(ds, t))
        if shape_px is None:
            shape_px = img.shape
            binning = np.minimum(binning, np.asarray(shape_px))
        binned.append(
            downsample_image_anisotropic(img, tuple(int(v) for v in binning))
        )
        del img
    size_um = np.asarray(shape_px) * spacing
    spacing_binned = spacing * binning

    # pairwise measurements: correction_j - correction_i (µm)
    rows, rhs, weights = [], [], []
    n_pruned = n_lowq = 0
    # collect the candidate pairs first, then register them on a small
    # thread pool: each pair's staged registration is several sequential
    # device dispatch→readback round trips, and on a high-latency link
    # the link latency (not device compute) dominates — overlapping
    # pairs hides it (the first pair runs alone to warm the per-shape
    # jit caches without a trace race)
    pair_specs = []
    for i in range(n_tiles):
        for j in range(i + 1, n_tiles):
            if keep_axis_aligned and not _is_axis_aligned_pair(
                origins[i], origins[j], size_um
            ):
                n_pruned += 1
                continue
            ob = _overlap_bounds(
                origins[i], origins[j], binned[0].shape, spacing_binned
            )
            if ob is None:
                continue
            (lo_i, hi_i), (lo_j, hi_j) = ob
            sub_i = binned[i][
                lo_i[0] : hi_i[0], lo_i[1] : hi_i[1], lo_i[2] : hi_i[2]
            ]
            sub_j = binned[j][
                lo_j[0] : hi_j[0], lo_j[1] : hi_j[1], lo_j[2] : hi_j[2]
            ]
            shp = np.minimum(sub_i.shape, sub_j.shape)
            # bucket each axis DOWN a ~1.3x geometric ladder: every
            # jitted candidate-scoring program is shape-specialized, and
            # ragged per-pair overlap crops would compile one program
            # variant per pair. Bucketing costs <=23% of the overlap
            # rows at the far edge and collapses a 42-tile grid's pair
            # shapes to a handful of variants.
            shp = np.asarray([_bucket_size(int(v)) for v in shp])
            if np.any(shp < 4):
                continue
            pair_specs.append(
                (
                    i,
                    j,
                    sub_i[: shp[0], : shp[1], : shp[2]],
                    sub_j[: shp[0], : shp[1], : shp[2]],
                    lo_i,
                    lo_j,
                    tuple(int(v) for v in shp),
                )
            )

    # pairwise registrations fan out over the visible devices (round-robin
    # by pair index): sharding the stitching graph's
    # pairwise registrations across cards (SURVEY §2.9; reference runs
    # them under dask on one GPU, `DataRegistration.py:1920`). Each pair's
    # numerics are computed wholly on one device, so the resolved global
    # transforms are bit-identical to a single-device run regardless of
    # device count (pinned in `tests/test_parallel.py`).
    import jax as _jax

    pair_devices = list(devices) if devices else _jax.devices()

    def run_pair(spec, device=None):
        i, j, sub_i, sub_j, lo_i, lo_j, shp = spec
        t_pair = time.perf_counter()
        with _jax.default_device(device or pair_devices[0]):
            shift_px, quality = register_translation_with_quality(
                sub_i, sub_j, upsample_factor=10
            )
        _mv_diag(
            diagnostics,
            "pair",
            pair=(i, j),
            overlap_shape=shp,
            shift_binned_px=np.round(np.asarray(shift_px), 3).tolist(),
            quality=round(float(quality), 4),
            elapsed_s=round(time.perf_counter() - t_pair, 3),
        )
        return shift_px, quality

    # Warm one representative pair PER DISTINCT bucket shape sequentially
    # before fanning out: the scoring program is shape-specialized, and
    # concurrent first-traces of the same shape from pool threads would
    # race the trace cache and duplicate compiles. Remaining pairs hit
    # compiled code.
    results: list = [None] * len(pair_specs)
    warmed_shapes: set = set()
    remaining: list[int] = []
    for k, spec in enumerate(pair_specs):
        if spec[6] not in warmed_shapes:
            warmed_shapes.add(spec[6])
            results[k] = run_pair(spec)
        else:
            remaining.append(k)
    if remaining:
        from concurrent.futures import ThreadPoolExecutor

        workers = max(4, len(pair_devices))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for k, res in zip(
                remaining,
                pool.map(
                    lambda kk: run_pair(
                        pair_specs[kk],
                        pair_devices[kk % len(pair_devices)],
                    ),
                    remaining,
                ),
            ):
                results[k] = res

    for spec, res in zip(pair_specs, results):
        i, j, _sub_i, _sub_j, lo_i, lo_j, _shp = spec
        shift_px, quality = res
        if not np.isfinite(quality) or quality < quality_threshold:
            n_lowq += 1
            if verbose > 1:
                print(
                    f"pair ({i},{j}): rejected, quality={quality:.3f} "
                    f"< {quality_threshold}"
                )
            continue
        # if sub_j(x) = sub_i(x - δ) then push = -δ and tile j's stage
        # origin overshoots by δ: correction_j - correction_i = push·s.
        # The two crops were floored to their own pixel grids, so even
        # at ZERO stage error the PCC measures push = -base_px, where
        # base_px is the sub-pixel offset between the crops' global
        # start positions — subtract that baseline or it is baked
        # into every correction as fake stage error (review r3)
        base_px = (origins[i] - origins[j]) / spacing_binned + (
            np.asarray(lo_i, np.float64) - np.asarray(lo_j, np.float64)
        )
        measured_um = (
            np.asarray(shift_px, np.float64) + base_px
        ) * spacing_binned
        row_block = np.zeros((3, 3 * n_tiles))
        for ax in range(3):
            row_block[ax, 3 * j + ax] = 1.0
            row_block[ax, 3 * i + ax] = -1.0
        rows.append(row_block)
        rhs.append(measured_um)
        weights.append(max(float(quality), 1e-3))
        if verbose > 1:
            print(f"pair ({i},{j}): shift_px={shift_px}, q={quality:.3f}")

    if verbose:
        print(
            f"global registration: {len(rows)} pairs kept, "
            f"{n_pruned} pruned (axis-aligned), {n_lowq} below quality "
            f"threshold {quality_threshold}"
        )

    corrections = np.zeros((n_tiles, 3))
    if rows:
        A = np.concatenate(rows, axis=0)
        b = np.concatenate(rhs, axis=0)
        # scale rows by sqrt(quality) so the LSQ objective is
        # sum(qualityₖ · rₖ²) — scaling by quality itself would weight by
        # quality² and nearly ignore low-quality pairs (review r3)
        w = np.sqrt(np.repeat(np.asarray(weights), 3))
        # anchor tile 0
        A = A[:, 3:]
        sol, *_ = np.linalg.lstsq(A * w[:, None], b * w, rcond=None)
        corrections[1:] = sol.reshape(n_tiles - 1, 3)

    for t in range(n_tiles):
        affine = np.eye(4)
        affine[:3, 3] = corrections[t]
        ds.save_global_coord_xforms_um(
            t,
            affine_zyx_um=affine,
            origin_zyx_um=origins[t],
            spacing_zyx_um=spacing,
        )
    state = ds.datastore_state
    state.update({"GlobalRegistered": True})
    ds.datastore_state = state
    fuse_global_registered(ds, config=fusion_config, verbose=verbose)


def _feather_ramp(n: int, edge: int) -> np.ndarray:
    ramp = np.minimum(np.arange(n) + 1, np.arange(n)[::-1] + 1).astype(np.float32)
    return np.minimum(ramp / max(min(edge, n // 2), 1), 1.0)


# Tiny LRU of loaded (possibly warped) tiles keyed by tile index, so a
# chunked fusion pass re-reads/re-warps each tile a bounded number of
# times while holding at most ``capacity`` tiles in host RAM.
_TileCache = LoaderCache


def stream_fuse(
    out_array,
    *,
    out_shape: Sequence[int],
    tile_starts_px: Sequence[np.ndarray],
    tile_shape_px: Sequence[int],
    tile_cache: _TileCache,
    chunk_px: int = 512,
    feather_px: int = 64,
    chunk_z: int = 64,
    out_offset: Sequence[int] = (0, 0, 0),
    max_projection: Optional[np.ndarray] = None,
) -> None:
    """Feathered weighted-average fusion, one output chunk at a time.

    For each (z, y, x) chunk of the global volume, reads only the
    intersecting windows of the intersecting tiles, accumulates
    ``sum(w·img) / sum(w)`` in a chunk-sized buffer, and writes the chunk
    straight into ``out_array`` (anything with a slice ``__setitem__``). Host memory
    is bounded by one chunk + the tile cache — the reference's
    direct-to-zarr chunked fusion (`DataRegistration.py:1728-1743`).

    Feather weights are evaluated analytically per window (the weight is a
    separable product of per-axis ramps), so no full tile-sized weight
    volume is ever materialized.
    """
    from ..datastore.prefetch import BoundedWriter

    out_shape = np.asarray(out_shape, int)
    tile_shape_px = np.asarray(tile_shape_px, int)
    ramps = [_feather_ramp(int(n), feather_px) for n in tile_shape_px]
    chunk = np.asarray([chunk_z, chunk_px, chunk_px], int)
    n_chunks = -(-out_shape // chunk)

    # chunk writes drain behind the accumulation of the next chunk
    # (write-behind, bounded at 2 pending chunk buffers)
    with BoundedWriter(depth=2) as writer:
        for cz in range(n_chunks[0]):
            for cy in range(n_chunks[1]):
                for cx in range(n_chunks[2]):
                    c_lo = np.asarray([cz, cy, cx]) * chunk
                    c_hi = np.minimum(c_lo + chunk, out_shape)
                    acc = np.zeros(c_hi - c_lo, np.float32)
                    wacc = np.zeros(c_hi - c_lo, np.float32)
                    for t, start in enumerate(tile_starts_px):
                        t_lo = np.maximum(c_lo, start)
                        t_hi = np.minimum(c_hi, start + tile_shape_px)
                        if np.any(t_hi <= t_lo):
                            continue
                        img = tile_cache.get(t)
                        if img is None:
                            continue
                        win = tuple(
                            slice(int(t_lo[ax] - start[ax]), int(t_hi[ax] - start[ax]))
                            for ax in range(3)
                        )
                        dst = tuple(
                            slice(int(t_lo[ax] - c_lo[ax]), int(t_hi[ax] - c_lo[ax]))
                            for ax in range(3)
                        )
                        w = (
                            ramps[0][win[0]][:, None, None]
                            * ramps[1][win[1]][None, :, None]
                            * ramps[2][win[2]][None, None, :]
                        )
                        acc[dst] += img[win] * w
                        wacc[dst] += w
                    fused = np.clip(acc / np.maximum(wacc, 1e-9), 0, 65535).astype(
                        np.uint16
                    )
                    dst_global = tuple(
                        slice(int(out_offset[ax] + c_lo[ax]), int(out_offset[ax] + c_hi[ax]))
                        for ax in range(3)
                    )
                    writer.submit(
                        out_array.__setitem__, dst_global, fused
                    )
                    if max_projection is not None:
                        mp_win = (dst_global[1], dst_global[2])
                        np.maximum(
                            max_projection[mp_win],
                            np.max(fused, axis=0),
                            out=max_projection[mp_win],
                        )


def _global_layout(ds, n_tiles, spacing):
    """(per-tile global origins µm, integer start px, tile shape px, bbox)."""
    origins = []
    for t in range(n_tiles):
        xf = ds.load_global_coord_xforms_um(t)
        if xf is None:
            origins.append(_tile_origin_um(ds, t))
        else:
            affine, origin, _ = xf
            origins.append(affine[:3, 3] + origin)
    shape_px = ds.local_image_shape(0, round=0, image="registered")
    if shape_px is None:
        shape_px = np.asarray(ds.load_local_corrected_image(tile=0, round=0)).shape
    shape_px = np.asarray(shape_px, int)
    lo = np.min(origins, axis=0)
    hi = np.max(origins, axis=0) + shape_px * spacing
    out_shape = np.ceil((hi - lo) / spacing).astype(int)
    starts = [np.round((o - lo) / spacing).astype(int) for o in origins]
    return origins, starts, shape_px, lo, out_shape


def fuse_global_registered(datastore, *, config=None, verbose=1):
    """Streamed feathered fusion of round-1 fiducials onto the global
    bounding box, written chunk-by-chunk directly into the fused OME-Zarr
    (+ global attrs + the Cellpose max-projection; reference
    `_fuse_global_registered_msims:1650-1837`)."""
    ds = datastore
    n_tiles = len(ds.tile_ids)
    spacing = np.asarray(ds.voxel_size_zyx_um, dtype=np.float64)
    overlap_px = getattr(config, "overlap_px", 64) if config else 64
    chunk_px = getattr(config, "chunk_px", 512) if config else 512
    cache_tiles = getattr(config, "tile_cache_tiles", 4) if config else 4

    _, starts, shape_px, lo, out_shape = _global_layout(ds, n_tiles, spacing)
    if verbose > 1:
        # fusion geometry diagnostics (reference
        # `_print_global_fusion_diagnostics:1563-1648`)
        chunk = np.asarray([64, chunk_px, chunk_px])
        _mv_diag(
            True,
            "fusion-geometry",
            n_tiles=n_tiles,
            tile_shape_px=tuple(int(v) for v in shape_px),
            global_shape_px=tuple(int(v) for v in out_shape),
            origin_um=np.round(lo, 3).tolist(),
            chunk_px=chunk_px,
            feather_px=overlap_px,
            n_chunks=int(np.prod(-(-out_shape // chunk))),
            tile_cache=cache_tiles,
        )

    out = ds.create_global_fused_image(
        tuple(int(v) for v in out_shape),
        np.uint16,
        affine_zyx_um=np.eye(4),
        origin_zyx_um=lo,
        spacing_zyx_um=spacing,
    )
    max_proj = np.zeros((int(out_shape[1]), int(out_shape[2])), np.uint16)

    def _loader(t: int) -> np.ndarray:
        img = _load_fiducial(ds, t)
        return _apply_camera_affine(img, _camera_affine_px(ds, t))

    stream_fuse(
        out,
        out_shape=out_shape,
        tile_starts_px=starts,
        tile_shape_px=shape_px,
        tile_cache=_TileCache(_loader, cache_tiles),
        chunk_px=chunk_px,
        feather_px=overlap_px,
        max_projection=max_proj,
    )
    if verbose:
        print(f"fused global volume {tuple(out_shape)} from {n_tiles} tiles")

    if getattr(config, "create_max_proj_tiff", True) if config else True:
        # Cellpose input artifact, as the reference writes after fusion
        # (`DataRegistration.py:1786-1825`).
        from ..utils.ometiff import write_ome_tiff_2d

        write_ome_tiff_2d(
            Path(ds._datastore_path)
            / "segmentation" / "cellpose" / "fiducial_max_projection.ome.tiff",
            max_proj,
            spacing_yx_um=(spacing[1], spacing[2]),
        )
    state = ds.datastore_state
    state.update({"GlobalRegistered": True, "Fused": True})
    ds.datastore_state = state
