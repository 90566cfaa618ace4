"""Staged pairwise fiducial registration (local affine).

JAX reimplementation of the reference registration stack
(`multiview_registration.register_pair_to_fixed:241-365`):

stage 1: phase correlation on max-Z projections → lateral pull shift,
stage 2: translate the moving volume by the lateral estimate, then
full-volume 3D phase correlation restricted to a statically-cropped
interior window (the static-shape answer to the reference's dynamic
`_overlap_slices_after_translation:83-113` crop — a data-dependent crop
size is a dynamic shape XLA cannot compile, so the applied stage-1
translation is clamped to the static margin and stage 2 measures the
remainder; the composition is exact) → residual shift.

Returns a 4x4 physical (µm) translation-only transform mapping
fixed/reference coordinates → moving coordinates (the convention expected by
:func:`merfish3d_tpu.ops.warp.warp_affine`).

Both stages and the output warp compile into ONE XLA program per round
batch (`register_rounds_to_fixed`), so an R-round batch costs one
dispatch + two readbacks instead of ~4R blocking device→host transfers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .phase_corr import phase_cross_correlation
from .warp import translate_volume


def _static_margin(n: int, cap: int = 64) -> int:
    """Static stage-2 crop margin for an axis of length ``n``: a quarter
    of the axis, capped, floored to a multiple of 8 (sublane-friendly and
    compilation-bucketed across rounds/tiles)."""
    return max((min(n // 4, cap) // 8) * 8, 0)


@partial(jax.jit, static_argnames=("upsample_factor", "return_warped"))
def _register_rounds_program(
    fixed: jnp.ndarray,
    movings: jnp.ndarray,
    upsample_factor: int,
    return_warped: bool,
):
    """One XLA program: staged registration of every moving round against
    ``fixed``. Sequential `lax.map` over rounds bounds HBM to one round's
    FFT working set (the batched stacks dominate otherwise)."""
    fixed = fixed.astype(jnp.float32)
    nz, ny, nx = fixed.shape
    my, mx = _static_margin(ny), _static_margin(nx)
    interior = (
        slice(None),
        slice(my, ny - my) if my else slice(None),
        slice(mx, nx - mx) if mx else slice(None),
    )
    fixed_proj = jnp.max(fixed, axis=0)
    fixed_crop = fixed[interior]
    # clamp the applied stage-1 translation so rolled wrap-around stays
    # inside the cropped margin; stage 2 measures the clamped remainder
    lim = jnp.asarray(
        [my - 1 if my else float(ny), mx - 1 if mx else float(nx)],
        jnp.float32,
    )

    def one(moving):
        moving = moving.astype(jnp.float32)
        xy_push = phase_cross_correlation(
            fixed_proj, jnp.max(moving, axis=0), upsample_factor=upsample_factor
        )
        applied = jnp.clip(-xy_push, -lim, lim)
        moving_xy = translate_volume(
            moving, jnp.concatenate([jnp.zeros(1, jnp.float32), applied])
        )
        residual_push = phase_cross_correlation(
            fixed_crop, moving_xy[interior], upsample_factor=upsample_factor
        )
        total_pull = -residual_push + jnp.concatenate(
            [jnp.zeros(1, jnp.float32), applied]
        )
        if not return_warped:
            return total_pull, jnp.zeros((), jnp.uint16)
        # the output warp for a translation-only transform IS
        # `translate_volume` (the same fast path `warp_affine` takes), and
        # the datastore stores uint16 — converting on device halves the
        # readback bytes
        warped = translate_volume(moving, total_pull)
        return total_pull, jnp.clip(warped, 0.0, 65535.0).astype(jnp.uint16)

    return jax.lax.map(one, movings)


def register_rounds_to_fixed(
    fixed: np.ndarray,
    movings: np.ndarray,
    *,
    spacing_zyx_um,
    upsample_factor: int = 10,
    return_warped: bool = False,
) -> tuple[np.ndarray, "np.ndarray | None"]:
    """Register a (R, z, y, x) stack of moving rounds against ``fixed``.

    Returns ``(transforms, warped)``: (R, 4, 4) physical µm transforms and,
    when ``return_warped``, the (R, z, y, x) uint16 stack of the moving
    rounds resampled into the fixed frame (else ``None``). The whole batch
    runs as one device program with two blocking readbacks total.

    Device arrays pass through without a host bounce (`np.asarray` on a
    device-resident stack would download + re-upload the full volume)."""
    if not hasattr(movings, "ndim"):
        movings = np.stack(movings)
    if movings.ndim != 4 or movings.shape[1:] != tuple(fixed.shape):
        raise ValueError(
            f"expected (R, *{tuple(fixed.shape)}) movings, got {movings.shape}"
        )
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    shifts, warped = _register_rounds_program(
        jnp.asarray(fixed, jnp.float32),
        jnp.asarray(movings, jnp.float32),
        upsample_factor,
        return_warped,
    )
    shifts_np = np.asarray(shifts)  # (R, 3) — one tiny readback
    transforms = np.tile(np.eye(4, dtype=np.float32), (len(shifts_np), 1, 1))
    transforms[:, :3, 3] = shifts_np * spacing
    return transforms, (np.asarray(warped) if return_warped else None)


def register_pair_to_fixed(
    fixed: np.ndarray,
    moving: np.ndarray,
    *,
    spacing_zyx_um,
    upsample_factor: int = 10,
) -> np.ndarray:
    """Estimate the 4x4 physical transform aligning ``moving`` to ``fixed``
    (single-pair wrapper over the batched round program)."""
    if fixed.shape != moving.shape or fixed.ndim != 3:
        raise ValueError(
            f"expected matching 3D shapes, got {fixed.shape} vs {moving.shape}"
        )
    transforms, _ = register_rounds_to_fixed(
        fixed,
        moving[None],
        spacing_zyx_um=spacing_zyx_um,
        upsample_factor=upsample_factor,
    )
    return transforms[0]


# ---------------------------------------------------------------- reference
# name-compatible surface (`utils/multiview_registration.py` public API)
def registration_binning_from_spacing(spacing_zyx_um) -> dict:
    """Phase-registration binning from voxel spacing: Z unbinned, Y/X
    binned to roughly isotropic voxels (reference
    `multiview_registration.py:135-158`)."""
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    if spacing.shape[0] != 3:
        raise ValueError("spacing_zyx_um must have three ZYX elements.")
    return {
        "z": 1,
        "y": max(1, round(float(spacing[0] / spacing[1]))),
        "x": max(1, round(float(spacing[0] / spacing[2]))),
    }


def cucim_phase_correlation_registration(
    fixed_data,
    moving_data,
    disambiguate_region_mode=None,
    **phase_corr_kwargs,
):
    """Pairwise pixel-space registration under the multiview-stitcher
    plugin contract: returns ``{"affine_matrix", "quality"}`` (reference
    `multiview_registration.py:624-832`; here the candidate-batched
    `phase_corr.register_translation_with_quality` does the work —
    ``disambiguate_region_mode`` is accepted for contract parity; the
    scorer always evaluates rolled-overlap SSIM candidates)."""
    from .phase_corr import register_translation_with_quality

    fixed = np.asarray(getattr(fixed_data, "data", fixed_data), np.float32)
    moving = np.asarray(getattr(moving_data, "data", moving_data), np.float32)
    fixed = np.nan_to_num(fixed)
    moving = np.nan_to_num(moving)
    upsample = int(
        phase_corr_kwargs.pop("upsample_factor", 10 if fixed.ndim == 2 else 2)
    )
    shift, quality = register_translation_with_quality(
        fixed, moving, upsample_factor=upsample
    )
    ndim = fixed.ndim
    affine = np.eye(ndim + 1, dtype=np.float64)
    affine[:ndim, ndim] = np.asarray(shift, np.float64)
    return {"affine_matrix": affine, "quality": float(quality)}


def warp_array_to_reference_gpu(
    image,
    *,
    transform_zyx_um,
    spacing_zyx_um,
    reference_shape,
    reference_origin_zyx_um=(0.0, 0.0, 0.0),
    mode: str = "constant",
    cval: float = 0.0,
    order: int = 1,
    gpu_id: int = 0,
    z_batch_size: int = 4,
    diagnostics: bool = False,
) -> np.ndarray:
    """Reference-named warp entry (`multiview_registration.py:835-941`);
    the device warp is :func:`merfish3d_tpu.ops.warp.warp_affine`
    (``mode`` other than constant-fill and ``gpu_id`` are CUDA-isms —
    constant fill matches the reference's default contract)."""
    from .warp import warp_affine

    del mode, gpu_id, diagnostics
    return warp_affine(
        image,
        transform_zyx_um=np.asarray(transform_zyx_um),
        spacing_zyx_um=spacing_zyx_um,
        reference_shape=reference_shape,
        reference_origin_zyx_um=reference_origin_zyx_um,
        cval=float(cval),
        order=int(order),
        z_chunk=max(1, int(z_batch_size)),
    )


def warp_array_to_reference_with_affine_and_sofima_flow_gpu(
    image,
    transform_zyx_um,
    spacing_zyx_um,
    reference_shape,
    sofima_flow_field_xyz_px,
    flow_field_stride_zyx_px,
    flow_field_box_start_xyz_px,
    reference_origin_zyx_um=(0.0, 0.0, 0.0),
    mode: str = "constant",
    cval: float = 0.0,
    order: int = 1,
    gpu_id: int = 0,
    z_batch_size: int = 4,
    diagnostics: bool = False,
) -> np.ndarray:
    """Reference-named composed affine∘flow warp
    (`multiview_registration.py:944-1171`); single-resample device path is
    :func:`merfish3d_tpu.ops.warp.warp_affine_plus_flow`."""
    from .warp import warp_affine_plus_flow

    del mode, cval, order, gpu_id, diagnostics
    return warp_affine_plus_flow(
        image,
        np.asarray(sofima_flow_field_xyz_px, np.float32),
        transform_zyx_um=np.asarray(transform_zyx_um),
        spacing_zyx_um=spacing_zyx_um,
        reference_shape=reference_shape,
        map_stride_zyx_px=flow_field_stride_zyx_px,
        map_box_start_xyz_px=flow_field_box_start_xyz_px,
        reference_origin_zyx_um=reference_origin_zyx_um,
        z_chunk=max(1, int(z_batch_size)),
    )


def sim_from_array(image, *, spacing_zyx_um, origin_zyx_um=(0.0, 0.0, 0.0)):
    """multiview-stitcher SpatialImage from a ZYX array (reference
    `multiview_registration.py:161-192`). Import-gated: requires the
    optional multiview-stitcher package."""
    from multiview_stitcher import spatial_image_utils as si_utils

    return si_utils.get_sim_from_array(
        image,
        dims=("z", "y", "x"),
        scale={k: float(v) for k, v in zip("zyx", spacing_zyx_um)},
        translation={k: float(v) for k, v in zip("zyx", origin_zyx_um)},
        transform_key="stage_metadata",
    )


def msim_from_array(image, *, spacing_zyx_um, origin_zyx_um=(0.0, 0.0, 0.0)):
    """multiview-stitcher multiscale image from a ZYX array (reference
    `multiview_registration.py:195-230`). Import-gated."""
    from multiview_stitcher import msi_utils

    return msi_utils.get_msim_from_sim(
        sim_from_array(
            image, spacing_zyx_um=spacing_zyx_um, origin_zyx_um=origin_zyx_um
        ),
        scale_factors=[],
    )
