"""Affine and affine+flow volume warps.

JAX replacement for ``cupyx.scipy.ndimage.affine_transform`` /
``map_coordinates`` warps (reference `multiview_registration.py:835-1171`).
All warps use trilinear ``jax.scipy.ndimage.map_coordinates`` (order=1,
constant fill) on static-shape coordinate grids; large volumes are warped
in z-chunks via ``lax.map`` so the coordinate grid never exceeds
``z_chunk × Y × X``.

Physical-transform convention (matches the reference exactly): the 4x4
``transform_zyx_um`` maps output/reference physical coordinates to
input/moving physical coordinates, with
``matrix_px = (A * s_row) / s_col`` and
``offset_px = (A @ origin + t - origin) / s``
(reference `multiview_registration.py:906-907`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..device import scale_budget


def transform_to_pixel(
    transform_zyx_um: np.ndarray,
    spacing_zyx_um,
    origin_zyx_um=(0.0, 0.0, 0.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Convert a physical 4x4 (ref→moving) to pixel matrix + offset."""
    transform = np.asarray(transform_zyx_um, dtype=np.float32)
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    origin = np.asarray(origin_zyx_um, dtype=np.float32)
    linear = transform[:3, :3]
    translation = transform[:3, 3]
    matrix_px = (linear * spacing[np.newaxis, :]) / spacing[:, np.newaxis]
    offset_px = (linear @ origin + translation - origin) / spacing
    return matrix_px, offset_px


@partial(jax.jit, static_argnames=("cval",))
def translate_volume(
    vol: jnp.ndarray, shift_pull_px: jnp.ndarray, cval: float = 0.0
) -> jnp.ndarray:
    """Subpixel pure translation: ``out[p] = vol[p + shift]`` (pull shift),
    zero (``cval``) outside.

    Translation is separable, so each axis is one roll-pair linear blend —
    pure elementwise/memory traffic instead of the trilinear
    ``map_coordinates`` gather. Used for the
    translation-only warps in staged registration (the stage-1 lateral
    pull, `multiview_registration.py:241-365`).
    """
    out = vol.astype(jnp.float32)
    shift = jnp.asarray(shift_pull_px, jnp.float32)
    for ax in range(vol.ndim):
        n = vol.shape[ax]
        s = shift[ax]
        i = jnp.floor(s).astype(jnp.int32)
        f = s - i.astype(jnp.float32)
        a = jnp.roll(out, -i, axis=ax)
        b = jnp.roll(out, -(i + 1), axis=ax)
        # per-sample validity so the boundary strips blend with cval
        # exactly like order-1 map_coordinates in 'constant' mode
        pos = jax.lax.broadcasted_iota(jnp.int32, out.shape, ax)
        ia = pos + i
        valid_a = (ia >= 0) & (ia <= n - 1)
        valid_b = (ia + 1 >= 0) & (ia + 1 <= n - 1)
        out = (1.0 - f) * jnp.where(valid_a, a, cval) + f * jnp.where(
            valid_b, b, cval
        )
    return out


@partial(jax.jit, static_argnames=("cval",))
def separable_diagonal_resample(
    vol: jnp.ndarray,
    scale: jnp.ndarray,
    offset_px: jnp.ndarray,
    cval: float = 0.0,
) -> jnp.ndarray:
    """Trilinear resample under a DIAGONAL pixel affine:
    ``out[p] = vol[scale ⊙ p + offset]``.

    Tensor-product linear interpolation is exactly separable, so a
    scale+translation warp is three 1-D resamples (two ``jnp.take`` + a
    blend per axis) instead of the 3-D ``map_coordinates`` gather, and
    bit-identical to the gather path away from knife-edge boundary
    rounding. This is the production decode-warp case: round transforms
    are translations and chromatic affines are per-axis scales
    (`pipeline/decode_warping.py`).
    """
    out = vol.astype(jnp.float32)
    for ax in range(vol.ndim):
        n = out.shape[ax]
        pos = jnp.arange(n, dtype=jnp.float32)
        src = scale[ax] * pos + offset_px[ax]
        i0r = jnp.floor(src).astype(jnp.int32)
        f = src - i0r.astype(jnp.float32)
        i0 = jnp.clip(i0r, 0, n - 1)
        i1 = jnp.clip(i0r + 1, 0, n - 1)
        a = jnp.take(out, i0, axis=ax)
        b = jnp.take(out, i1, axis=ax)
        sb = [1] * vol.ndim
        sb[ax] = n
        fb = f.reshape(sb)
        va = ((i0r >= 0) & (i0r <= n - 1)).reshape(sb)
        vb = ((i0r + 1 >= 0) & (i0r + 1 <= n - 1)).reshape(sb)
        out = (1.0 - fb) * jnp.where(va, a, cval) + fb * jnp.where(
            vb, b, cval
        )
    return out


@partial(jax.jit, static_argnames=("reference_shape", "order", "z_chunk", "cval"))
def _affine_warp_core(
    image: jnp.ndarray,
    matrix_px: jnp.ndarray,
    offset_px: jnp.ndarray,
    *,
    reference_shape: tuple[int, int, int],
    order: int = 1,
    z_chunk: int = 8,
    cval: float = 0.0,
):
    nz, ny, nx = reference_shape
    yy, xx = jnp.meshgrid(
        jnp.arange(ny, dtype=jnp.float32),
        jnp.arange(nx, dtype=jnp.float32),
        indexing="ij",
    )

    def warp_plane_block(z0):
        zs = z0 + jnp.arange(z_chunk, dtype=jnp.float32)
        # output coords (z_chunk, ny, nx)
        zc = jnp.broadcast_to(zs[:, None, None], (z_chunk, ny, nx))
        yc = jnp.broadcast_to(yy[None], (z_chunk, ny, nx))
        xc = jnp.broadcast_to(xx[None], (z_chunk, ny, nx))
        # explicit per-axis multiply-adds, NOT matrix @ coords: a default-
        # precision float32 matmul may run in reduced precision (TF32 on
        # the GPU), which rounds pixel coordinates to multi-pixel errors at
        # x ≳ 512
        src = [
            matrix_px[a, 0] * zc
            + matrix_px[a, 1] * yc
            + matrix_px[a, 2] * xc
            + offset_px[a]
            for a in range(3)
        ]
        return jax.scipy.ndimage.map_coordinates(
            image, src, order=order, mode="constant", cval=cval
        )

    n_blocks = -(-nz // z_chunk)
    z_starts = jnp.arange(n_blocks, dtype=jnp.float32) * z_chunk
    out = jax.lax.map(warp_plane_block, z_starts)
    return out.reshape(n_blocks * z_chunk, ny, nx)[:nz]


def warp_affine(
    image,
    *,
    transform_zyx_um,
    spacing_zyx_um,
    reference_shape,
    reference_origin_zyx_um=(0.0, 0.0, 0.0),
    cval: float = 0.0,
    order: int = 1,
    z_chunk: int = 8,
) -> np.ndarray:
    """Warp ``image`` onto the reference grid under a physical 4x4 affine
    (reference `warp_array_to_reference_gpu`, `multiview_registration.py:835-941`)."""
    matrix_px, offset_px = transform_to_pixel(
        transform_zyx_um, spacing_zyx_um, reference_origin_zyx_um
    )
    # Separable fast paths (no 3-D gather):
    # - pure translation → roll-blend (`translate_volume`)
    # - diagonal scale + translation → per-axis 1-D resamples
    #   (`separable_diagonal_resample`) — the decode-warp production case
    #   (round translation ∘ chromatic per-axis scale)
    if (
        order == 1
        and tuple(int(v) for v in reference_shape) == tuple(image.shape)
        and np.allclose(matrix_px, np.diag(np.diag(matrix_px)), atol=1e-8)
    ):
        if np.allclose(np.diag(matrix_px), 1.0, atol=1e-6):
            return np.asarray(
                translate_volume(
                    jnp.asarray(image, jnp.float32),
                    jnp.asarray(offset_px, jnp.float32),
                    cval=float(cval),
                )
            )
        return np.asarray(
            separable_diagonal_resample(
                jnp.asarray(image, jnp.float32),
                jnp.asarray(np.diag(matrix_px), jnp.float32),
                jnp.asarray(offset_px, jnp.float32),
                cval=float(cval),
            )
        )
    out = _affine_warp_core(
        jnp.asarray(image, jnp.float32),
        jnp.asarray(matrix_px),
        jnp.asarray(offset_px),
        reference_shape=tuple(int(v) for v in reference_shape),
        order=order,
        z_chunk=z_chunk,
        cval=float(cval),
    )
    return np.asarray(out)


def _upsample_flow_channel(ch, *, out_shape, stride_zyx, box_start_zyx):
    """Interpolate one lattice flow channel onto the full voxel grid.

    The lattice→voxel coordinate map is diagonal (per-axis stride +
    offset), so trilinear interpolation with clamped coordinates
    (``map_coordinates`` ``mode='nearest'``) factors exactly into three
    1-D takes — no 3-D gather for the flow upsample."""
    out = ch.astype(jnp.float32)
    for ax in range(3):
        n = out_shape[ax]
        m = out.shape[ax]
        pos = jnp.arange(n, dtype=jnp.float32)
        src = jnp.clip(
            (pos - box_start_zyx[ax]) / stride_zyx[ax], 0.0, float(m - 1)
        )
        i0 = jnp.floor(src).astype(jnp.int32)
        f = src - i0.astype(jnp.float32)
        i1 = jnp.minimum(i0 + 1, m - 1)
        a = jnp.take(out, i0, axis=ax)
        b = jnp.take(out, i1, axis=ax)
        sb = [1, 1, 1]
        sb[ax] = n
        fb = f.reshape(sb)
        out = (1.0 - fb) * a + fb * b
    return out


def _variable_shift_axis(vol, shift, axis, k0, k1):
    """1-D linear resample with a PER-VOXEL source shift along ``axis``:
    ``out[p] = lerp(vol, p_axis + shift[p])`` with constant-0 edges.

    ``shift`` is bounded in ``[k0, k1)`` (static host-derived bounds), so
    the variable-shift gather unrolls into ``k1 - k0 + 1`` static rolls
    with hat weights ``max(0, 1 - |shift - k|)`` — exactly two of which
    are nonzero at each voxel. Pure VPU/memory traffic instead of a
    per-voxel gather (the generalization of ``translate_volume``'s
    roll-blend to a shift FIELD)."""
    pos = jax.lax.broadcasted_iota(jnp.int32, vol.shape, axis)
    n = vol.shape[axis]
    acc = jnp.zeros(vol.shape, jnp.float32)
    for k in range(k0, k1 + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(shift - jnp.float32(k)))
        valid = ((pos + k) >= 0) & ((pos + k) <= n - 1)
        acc = acc + w * jnp.where(valid, jnp.roll(vol, -k, axis=axis), 0.0)
    return acc


@partial(jax.jit, static_argnames=("k_ranges", "out_shape"))
def _flow_warp_separable_core(
    image: jnp.ndarray,
    flow_xyz: jnp.ndarray,  # (3, fz, fy, fx), channels X, Y, Z
    scale: jnp.ndarray,  # (3,) diagonal of the pixel affine
    offset_px: jnp.ndarray,  # (3,)
    stride_zyx: jnp.ndarray,
    box_start_zyx: jnp.ndarray,
    *,
    k_ranges: tuple[tuple[int, int], ...],
    out_shape: tuple[int, int, int],
):
    """Separable composed diagonal-affine + flow warp.

    The composed source coordinate per output voxel is
    ``c_a = m_a (p_a + d_a(p)) + off_a``, i.e. a per-voxel shift field
    ``s_a(p) = (m_a - 1) p_a + m_a d_a(p) + off_a`` along each axis.
    Applying the three 1-D variable-shift resamples sequentially (z, y,
    x) replaces the per-voxel trilinear gather with ~Σ(k1-k0) fused
    roll-blend sweeps. The factorization is EXACT for constant flows; for
    varying flows the pass-k term evaluates earlier axes' shifts at
    lattice-smooth displaced rows, an error bounded by
    ``|s|·‖∇d‖ ≈ |s|·Δd/stride`` px — well under the flow estimator's
    own noise for SOFIMA-scale lattices (stride ≥ 16 px, |d| ≲ 10 px).
    Used automatically by `warp_affine_plus_flow` when the pixel affine
    is diagonal (the production decode-warp case); general affines keep
    the gather path."""
    out = image.astype(jnp.float32)
    for ax, ch in ((0, 2), (1, 1), (2, 0)):
        d = _upsample_flow_channel(
            flow_xyz[ch],
            out_shape=out_shape,
            stride_zyx=stride_zyx,
            box_start_zyx=box_start_zyx,
        )
        pos = jax.lax.broadcasted_iota(jnp.float32, out_shape, ax)
        s = (scale[ax] - 1.0) * pos + offset_px[ax] + scale[ax] * d
        out = _variable_shift_axis(out, s, ax, *k_ranges[ax])
    return out


# total unrolled roll terms allowed across the three axes before the
# separable path loses to the gather (each term ≈ 2 fused HBM sweeps;
# 160 sweeps ≈ 45 ms at (32, 1024, 1024) vs 20.8 s for the gather)
_SEPARABLE_FLOW_MAX_TERMS = 160

# Device-memory budget for the batched separable flow warp's vmap width
# (each roll-blend term is a full (group, z, y, x) f32 buffer), given at
# the 16 GiB reference limit and scaled to the device
# (`device.scale_budget`); tests shrink it to force the chunked path
_FLOW_WARP_HBM_BUDGET = 10 << 30
# the same for the batched affine warps' sub-batches
_AFFINE_BATCH_HBM_BUDGET = 12 << 30


def _separable_flow_bounds(
    matrix_px: np.ndarray,
    offset_px: np.ndarray,
    flow_xyz: np.ndarray,
    reference_shape,
) -> tuple[tuple[int, int], ...] | None:
    """Static per-axis roll ranges for the separable flow warp, or None
    when ineligible (non-diagonal affine, unbounded shift range)."""
    if not np.allclose(matrix_px, np.diag(np.diag(matrix_px)), atol=1e-8):
        return None
    if not np.all(np.isfinite(flow_xyz)):
        return None
    scale = np.diag(matrix_px).astype(np.float64)
    ranges = []
    total = 0
    for ax, ch in ((0, 2), (1, 1), (2, 0)):
        n = float(reference_shape[ax]) - 1.0
        m = scale[ax]
        dmin = float(flow_xyz[ch].min())
        dmax = float(flow_xyz[ch].max())
        lin = [(m - 1.0) * 0.0, (m - 1.0) * n]
        dd = [m * dmin, m * dmax]
        smin = min(lin) + min(dd) + float(offset_px[ax])
        smax = max(lin) + max(dd) + float(offset_px[ax])
        k0 = int(np.floor(smin))
        k1 = int(np.floor(smax)) + 1
        ranges.append((k0, k1))
        total += k1 - k0 + 1
    if total > _SEPARABLE_FLOW_MAX_TERMS:
        return None
    return tuple(ranges)


@partial(jax.jit, static_argnames=("reference_shape", "z_chunk"))
def _affine_flow_warp_core(
    image: jnp.ndarray,
    flow_xyz: jnp.ndarray,  # (3, fz, fy, fx), channels X, Y, Z
    matrix_px: jnp.ndarray,
    offset_px: jnp.ndarray,
    map_stride_zyx_px: jnp.ndarray,
    map_box_start_zyx_px: jnp.ndarray,
    *,
    reference_shape: tuple[int, int, int],
    z_chunk: int = 4,
):
    """Single-resample composed warp: interpolate the SOFIMA flow at each
    reference voxel, displace, then apply the pixel affine and sample the
    native moving image once
    (reference `multiview_registration.py:944-1171`)."""
    nz, ny, nx = reference_shape
    yy, xx = jnp.meshgrid(
        jnp.arange(ny, dtype=jnp.float32),
        jnp.arange(nx, dtype=jnp.float32),
        indexing="ij",
    )

    def warp_block(z0):
        zs = z0 + jnp.arange(z_chunk, dtype=jnp.float32)
        zc = jnp.broadcast_to(zs[:, None, None], (z_chunk, ny, nx))
        yc = jnp.broadcast_to(yy[None], (z_chunk, ny, nx))
        xc = jnp.broadcast_to(xx[None], (z_chunk, ny, nx))
        # flow lattice coordinates of each reference voxel
        fz = (zc - map_box_start_zyx_px[0]) / map_stride_zyx_px[0]
        fy = (yc - map_box_start_zyx_px[1]) / map_stride_zyx_px[1]
        fx = (xc - map_box_start_zyx_px[2]) / map_stride_zyx_px[2]
        interp = lambda ch: jax.scipy.ndimage.map_coordinates(
            ch, [fz, fy, fx], order=1, mode="nearest"
        )
        dx = interp(flow_xyz[0])
        dy = interp(flow_xyz[1])
        dz = interp(flow_xyz[2])
        # displaced reference coords (still in reference px)
        zd = zc + dz
        yd = yc + dy
        xd = xc + dx
        # elementwise multiply-adds (a coords matmul could run at reduced
        # precision — see _affine_warp_core)
        src = [
            matrix_px[a, 0] * zd
            + matrix_px[a, 1] * yd
            + matrix_px[a, 2] * xd
            + offset_px[a]
            for a in range(3)
        ]
        return jax.scipy.ndimage.map_coordinates(
            image, src, order=1, mode="constant", cval=0.0
        )

    n_blocks = -(-nz // z_chunk)
    z_starts = jnp.arange(n_blocks, dtype=jnp.float32) * z_chunk
    out = jax.lax.map(warp_block, z_starts)
    return out.reshape(n_blocks * z_chunk, ny, nx)[:nz]


def warp_affine_plus_flow(
    image,
    flow_xyz,
    *,
    transform_zyx_um,
    spacing_zyx_um,
    reference_shape,
    map_stride_zyx_px,
    map_box_start_xyz_px,
    reference_origin_zyx_um=(0.0, 0.0, 0.0),
    z_chunk: int = 4,
    method: str = "auto",
) -> np.ndarray:
    """Composed affine + SOFIMA-flow warp with a single resample of the
    native moving image. ``flow_xyz`` is ``(3, fz, fy, fx)`` with channels
    X, Y, Z and values in reference px (docs/datastore.md:46-51).

    ``method``: ``'auto'`` routes diagonal pixel affines (the production
    decode-warp case: round translation ∘ chromatic per-axis scale) to
    the separable roll-blend path (`_flow_warp_separable_core`) and
    everything else to the trilinear gather; ``'separable'`` /
    ``'gather'`` force a path (tests)."""
    matrix_px, offset_px = transform_to_pixel(
        transform_zyx_um, spacing_zyx_um, reference_origin_zyx_um
    )
    box_start_xyz = np.asarray(map_box_start_xyz_px, dtype=np.float32)
    box_start_zyx = box_start_xyz[::-1].copy()
    ref_shape = tuple(int(v) for v in reference_shape)
    flow_np = np.asarray(flow_xyz, np.float32)
    if method != "gather" and tuple(image.shape) == ref_shape:
        k_ranges = _separable_flow_bounds(
            matrix_px, offset_px, flow_np, ref_shape
        )
        if k_ranges is not None:
            return np.asarray(
                _flow_warp_separable_core(
                    jnp.asarray(image, jnp.float32),
                    jnp.asarray(flow_np),
                    jnp.asarray(np.diag(matrix_px), jnp.float32),
                    jnp.asarray(offset_px, jnp.float32),
                    jnp.asarray(map_stride_zyx_px, jnp.float32),
                    jnp.asarray(box_start_zyx),
                    k_ranges=k_ranges,
                    out_shape=ref_shape,
                )
            )
    if method == "separable":
        raise ValueError(
            "separable flow warp requires a diagonal pixel affine, "
            "image.shape == reference_shape, and bounded flow"
        )
    out = _affine_flow_warp_core(
        jnp.asarray(image, jnp.float32),
        jnp.asarray(flow_np),
        jnp.asarray(matrix_px),
        jnp.asarray(offset_px),
        jnp.asarray(map_stride_zyx_px, dtype=jnp.float32),
        jnp.asarray(box_start_zyx),
        reference_shape=ref_shape,
        z_chunk=z_chunk,
    )
    return np.asarray(out)


_translate_volume_batch = jax.jit(jax.vmap(lambda v, s: translate_volume(v, s)))
_separable_diagonal_batch = jax.jit(
    jax.vmap(lambda v, sc, off: separable_diagonal_resample(v, sc, off))
)


@partial(jax.jit, static_argnames=("reference_shape", "z_chunk"))
def _affine_warp_core_batch(
    images, matrices_px, offsets_px, *, reference_shape, z_chunk: int = 8
):
    return jax.vmap(
        lambda im, m, o: _affine_warp_core(
            im, m, o, reference_shape=reference_shape, z_chunk=z_chunk
        )
    )(images, matrices_px, offsets_px)


@partial(jax.jit, static_argnames=("reference_shape", "z_chunk"))
def _affine_flow_warp_core_batch(
    images,
    flows_xyz,
    matrices_px,
    offsets_px,
    strides_zyx,
    box_starts_zyx,
    *,
    reference_shape,
    z_chunk: int = 4,
):
    return jax.vmap(
        lambda im, fl, m, o, st, bs: _affine_flow_warp_core(
            im, fl, m, o, st, bs, reference_shape=reference_shape, z_chunk=z_chunk
        )
    )(images, flows_xyz, matrices_px, offsets_px, strides_zyx, box_starts_zyx)


def _sub_batches(
    n_items: int, item_bytes: int, hbm_budget_bytes: "int | None",
    live_per_item: int = 3,
):
    """Yield (start, stop) covering range(n_items) with ≤budget live bytes
    per dispatch. ``live_per_item`` is the number of item-sized buffers
    the vmapped path keeps resident simultaneously: ~3 for the gather
    warps (input + output + scratch), ~6 for the separable flow path
    (input, output accumulator, upsampled flow channel, shift field,
    rolled temp, blend — review r3: sizing the flow path at 3x admitted
    batches ~1.7x over budget). ``hbm_budget_bytes=None`` takes the
    device-scaled default."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = scale_budget(_AFFINE_BATCH_HBM_BUDGET)
    max_b = max(1, int(hbm_budget_bytes // max(1, live_per_item * item_bytes)))
    for s in range(0, n_items, max_b):
        yield s, min(n_items, s + max_b)


def _affine_batch_classes(transforms_zyx_um, spacing_zyx_um, n: int):
    """Shared host-side precompute for the batched affine warps: pixel
    matrices/offsets plus the translate/diagonal/general class split."""
    mats = np.empty((n, 3, 3), np.float32)
    offs = np.empty((n, 3), np.float32)
    for i in range(n):
        mats[i], offs[i] = transform_to_pixel(transforms_zyx_um[i], spacing_zyx_um)
    diag = np.array(
        [np.allclose(m, np.diag(np.diag(m)), atol=1e-8) for m in mats]
    )
    ident = diag & np.array(
        [np.allclose(np.diag(m), 1.0, atol=1e-6) for m in mats]
    )
    classes = (
        (np.flatnonzero(ident), "translate"),
        (np.flatnonzero(diag & ~ident), "diagonal"),
        (np.flatnonzero(~diag), "general"),
    )
    return mats, offs, classes


def warp_affine_batch_device(
    images,  # (B, z, y, x) device (or host) array
    transforms_zyx_um: np.ndarray,  # (B, 4, 4)
    spacing_zyx_um,
):
    """Device-in/device-out batched affine warps: numerics identical to
    `warp_affine_batch`, but the warped stack never leaves the device —
    the decode path feeds it straight into lowpass+decode, which removes a
    full (bits, z, y, x) f32 readback AND its re-upload from every tile
    decode. The caller guarantees the working set fits device memory
    (`pipeline/decoder.py` gates residency on the decode working set)."""
    images = jnp.asarray(images, jnp.float32)
    n = images.shape[0]
    mats, offs, classes = _affine_batch_classes(
        transforms_zyx_um, spacing_zyx_um, n
    )
    out = images
    for idx, kind in classes:
        if idx.size == 0:
            continue
        sel = jnp.asarray(idx)
        imgs = jnp.take(images, sel, axis=0)
        if kind == "translate":
            res = _translate_volume_batch(imgs, jnp.asarray(offs[idx]))
        elif kind == "diagonal":
            scales = np.stack([np.diag(mats[i]) for i in idx])
            res = _separable_diagonal_batch(
                imgs, jnp.asarray(scales), jnp.asarray(offs[idx])
            )
        else:
            res = _affine_warp_core_batch(
                imgs,
                jnp.asarray(mats[idx]),
                jnp.asarray(offs[idx]),
                reference_shape=tuple(images.shape[1:]),
            )
        out = out.at[sel].set(res)
    return out


def warp_affine_batch(
    images: np.ndarray,  # (B, z, y, x)
    transforms_zyx_um: np.ndarray,  # (B, 4, 4)
    spacing_zyx_um,
    *,
    hbm_budget_bytes: "int | None" = None,
) -> np.ndarray:
    """Batched same-shape affine warps in as few device dispatches as
    possible — the decode-time bit load warps every readout bit of a tile
    (reference `PixelDecoder._load_bit_data:1476-1595` loops bits through
    `warp_bit_image_to_reference`); per-bit dispatches pay one host↔device
    round trip each, which dominates warm per-tile wall-clock on
    high-latency links. Splits the batch by warp class (translation /
    diagonal / general — each has a different fast path) and sub-batches
    within an HBM budget. Numerics identical to per-item `warp_affine`."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    n = images.shape[0]
    out = np.empty_like(images)
    mats, offs, classes = _affine_batch_classes(
        transforms_zyx_um, spacing_zyx_um, n
    )
    item_bytes = images[0].nbytes
    for idx, kind in classes:
        if idx.size == 0:
            continue
        # roll-blend classes keep more item-sized buffers live than the
        # gather path (rolled copies per axis + blend accumulator)
        live = 3 if kind == "general" else 5
        for s, e in _sub_batches(
            idx.size, item_bytes, hbm_budget_bytes, live_per_item=live
        ):
            sel = idx[s:e]
            imgs = jnp.asarray(images[sel])
            if kind == "translate":
                res = _translate_volume_batch(imgs, jnp.asarray(offs[sel]))
            elif kind == "diagonal":
                scales = np.stack([np.diag(mats[i]) for i in sel])
                res = _separable_diagonal_batch(
                    imgs, jnp.asarray(scales), jnp.asarray(offs[sel])
                )
            else:
                res = _affine_warp_core_batch(
                    imgs,
                    jnp.asarray(mats[sel]),
                    jnp.asarray(offs[sel]),
                    reference_shape=images.shape[1:],
                )
            out[sel] = np.asarray(res)
    return out


def warp_affine_plus_flow_batch_device(
    images,  # (B, z, y, x) device (or host) array
    flows_xyz: np.ndarray,  # (B, 3, fz, fy, fx)
    transforms_zyx_um: np.ndarray,  # (B, 4, 4)
    spacing_zyx_um,
    map_strides_zyx_px: np.ndarray,  # (B, 3)
    map_box_starts_xyz_px: np.ndarray,  # (B, 3)
    *,
    z_chunk: int = 4,
):
    """Device-in/device-out batched composed affine+flow warps — same
    numerics and path selection as `warp_affine_plus_flow_batch`, single
    dispatch (the caller guarantees the working set fits HBM)."""
    images = jnp.asarray(images, jnp.float32)
    n = images.shape[0]
    out_shape = tuple(images.shape[1:])
    mats = np.empty((n, 3, 3), np.float32)
    offs = np.empty((n, 3), np.float32)
    for i in range(n):
        mats[i], offs[i] = transform_to_pixel(transforms_zyx_um[i], spacing_zyx_um)
    box_zyx = np.asarray(map_box_starts_xyz_px, np.float32)[:, ::-1].copy()
    flows_np = np.asarray(flows_xyz, np.float32)
    k_ranges = None
    per_item = [
        _separable_flow_bounds(mats[i], offs[i], flows_np[i], out_shape)
        for i in range(n)
    ]
    if all(r is not None for r in per_item):
        merged = tuple(
            (min(r[ax][0] for r in per_item), max(r[ax][1] for r in per_item))
            for ax in range(3)
        )
        if sum(k1 - k0 + 1 for k0, k1 in merged) <= _SEPARABLE_FLOW_MAX_TERMS:
            k_ranges = merged
    if k_ranges is not None:
        scales = np.stack([np.diag(mats[i]) for i in range(n)]).astype(np.float32)
        core = jax.vmap(
            lambda im, fl, sc, of, st, bs: _flow_warp_separable_core(
                im, fl, sc, of, st, bs,
                k_ranges=k_ranges,
                out_shape=out_shape,
            )
        )
        # memory-bound the vmap width: each roll-blend term materializes a
        # full (g, z, y, x) f32 buffer, so a 14-bit production tile at
        # (16, 1024, 1024) vmapped whole needs ~18 GB. Chunk to groups whose term working set fits; identical
        # numerics (vmap over disjoint groups).
        vol_bytes = 4 * int(np.prod(out_shape))
        n_terms = sum(k1 - k0 + 1 for k0, k1 in k_ranges)
        group = max(
            1,
            int(
                scale_budget(_FLOW_WARP_HBM_BUDGET)
                // (vol_bytes * (n_terms + 6))
            ),
        )
        strides_j = jnp.asarray(map_strides_zyx_px, jnp.float32)
        box_j = jnp.asarray(box_zyx)
        flows_j = jnp.asarray(flows_np)
        scales_j = jnp.asarray(scales)
        offs_j = jnp.asarray(offs)
        if group >= n:
            return core(images, flows_j, scales_j, offs_j, strides_j, box_j)
        outs = []
        for s in range(0, n, group):
            e = min(n, s + group)
            args = [images[s:e], flows_j[s:e], scales_j[s:e], offs_j[s:e],
                    strides_j[s:e], box_j[s:e]]
            if e - s < group:
                # pad the ragged tail by repeating the last item: ONE
                # compile variant instead of two; excess rows sliced off
                reps = group - (e - s)
                args = [
                    jnp.concatenate([a, jnp.repeat(a[-1:], reps, axis=0)])
                    for a in args
                ]
            outs.append(core(*args)[: e - s])
        return jnp.concatenate(outs, axis=0)
    return _affine_flow_warp_core_batch(
        images,
        jnp.asarray(flows_np),
        jnp.asarray(mats),
        jnp.asarray(offs),
        jnp.asarray(map_strides_zyx_px, jnp.float32),
        jnp.asarray(box_zyx),
        reference_shape=out_shape,
        z_chunk=z_chunk,
    )


def warp_affine_plus_flow_batch(
    images: np.ndarray,  # (B, z, y, x)
    flows_xyz: np.ndarray,  # (B, 3, fz, fy, fx)
    transforms_zyx_um: np.ndarray,  # (B, 4, 4)
    spacing_zyx_um,
    map_strides_zyx_px: np.ndarray,  # (B, 3)
    map_box_starts_xyz_px: np.ndarray,  # (B, 3)
    *,
    hbm_budget_bytes: "int | None" = None,
    z_chunk: int = 4,
) -> np.ndarray:
    """Batched composed affine+flow warps (per-item metadata, shared
    shapes): all flow-bearing bits of a tile warp in one dispatch instead
    of one per bit. Numerics identical to `warp_affine_plus_flow`."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    n = images.shape[0]
    mats = np.empty((n, 3, 3), np.float32)
    offs = np.empty((n, 3), np.float32)
    for i in range(n):
        mats[i], offs[i] = transform_to_pixel(transforms_zyx_um[i], spacing_zyx_um)
    box_zyx = np.asarray(map_box_starts_xyz_px, np.float32)[:, ::-1].copy()
    out = np.empty_like(images)
    flows_np = np.asarray(flows_xyz, np.float32)
    # one shared static roll range across the batch: the union of every
    # item's bounds (items vmap through one separable program)
    k_ranges = None
    per_item = [
        _separable_flow_bounds(mats[i], offs[i], flows_np[i], images.shape[1:])
        for i in range(n)
    ]
    if all(r is not None for r in per_item):
        merged = tuple(
            (min(r[ax][0] for r in per_item), max(r[ax][1] for r in per_item))
            for ax in range(3)
        )
        if sum(k1 - k0 + 1 for k0, k1 in merged) <= _SEPARABLE_FLOW_MAX_TERMS:
            k_ranges = merged
    if k_ranges is not None:
        scales = np.stack([np.diag(mats[i]) for i in range(n)]).astype(np.float32)
        core = jax.vmap(
            lambda im, fl, sc, of, st, bs: _flow_warp_separable_core(
                im, fl, sc, of, st, bs,
                k_ranges=k_ranges,
                out_shape=images.shape[1:],
            )
        )
        for s, e in _sub_batches(
            n, images[0].nbytes, hbm_budget_bytes, live_per_item=6
        ):
            out[s:e] = np.asarray(
                core(
                    jnp.asarray(images[s:e]),
                    jnp.asarray(flows_np[s:e]),
                    jnp.asarray(scales[s:e]),
                    jnp.asarray(offs[s:e]),
                    jnp.asarray(map_strides_zyx_px[s:e], jnp.float32),
                    jnp.asarray(box_zyx[s:e]),
                )
            )
        return out
    for s, e in _sub_batches(n, images[0].nbytes, hbm_budget_bytes):
        out[s:e] = np.asarray(
            _affine_flow_warp_core_batch(
                jnp.asarray(images[s:e]),
                jnp.asarray(flows_xyz[s:e], jnp.float32),
                jnp.asarray(mats[s:e]),
                jnp.asarray(offs[s:e]),
                jnp.asarray(map_strides_zyx_px[s:e], jnp.float32),
                jnp.asarray(box_zyx[s:e]),
                reference_shape=images.shape[1:],
                z_chunk=z_chunk,
            )
        )
    return out


def transform_points_to_reference(
    points_zyx_um: np.ndarray, transform_zyx_um: np.ndarray
) -> np.ndarray:
    """Map physical points from moving space back to reference space using
    the inverse affine (reference `multiview_registration.py:1174-1214`)."""
    inv = np.linalg.inv(np.asarray(transform_zyx_um, dtype=np.float64))
    pts = np.asarray(points_zyx_um, dtype=np.float64)
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    out = (inv @ homo.T).T[:, :3]
    return out.astype(np.float32)
