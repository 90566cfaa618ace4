"""Deformable residual flow estimation (SOFIMA-equivalent) in JAX.

Re-derivation of the reference SOFIMA pipeline
(`utils/sofima_registration.py:499-713`): after affine initialization, a
residual deformable flow field is estimated as

1. **batched patch cross-correlation** on a regular lattice (all patches
   cross-correlated in one vmapped FFT program — the reference calls
   SOFIMA's ``JAXMaskedXCorrWithStatsCalculator``),
2. **flow cleaning** by peak ratio / magnitude / deviation-from-median
   (reference ``flow_utils.clean_flow`` semantics),
3. **subpixel refinement** by 3-point parabolic interpolation of the
   correlation peak,
4. **dense relaxation**: invalid lattice sites are filled from the
   per-channel median, then the field is relaxed under a data +
   smoothness objective with Jacobi sweeps in a ``lax.while_loop`` (the
   explicit-integrator analog of ``sofima.mesh.relax_mesh``),
5. **axial stabilization**: Z flow clipped to median ± 5 px
   (`_stabilize_axial_flow_component:81-148`),
6. optional **residual iterations**: warp with the current field,
   re-estimate, and compose the fields on the same lattice
   (`_compose_flow_fields_same_grid:151-214`).

Output convention matches the datastore contract (docs/datastore.md:46-51):
shape ``(3, fz, fy, fx)``, channels X, Y, Z, values = displacement in
reference px (ref coordinate + flow = coordinate in the affine-initialized
moving image), lattice origin at the patch centers.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class SofimaRegistrationConfig:
    """Deformable-registration knobs, field-compatible with the reference
    `SofimaRegistrationConfig` (`utils/sofima_registration.py:9-46`).

    Two reference field groups have a different mechanism here and
    therefore different knobs:

    - ``subpixel_offsets`` / ``subpixel_batch_size`` (the reference's
      offset-resampled refinement pass) are superseded by the
      closed-form 3-point parabolic peak fit inside the x-corr kernel —
      no resampling pass exists to parameterize;
    - ``mesh_*`` (the elastic-mesh explicit integrator) map onto the
      Jacobi relaxation's ``relax_smoothness`` (≈ mesh_k/mesh_k0),
      ``relax_iterations`` (≈ mesh_num_iters) and ``relax_tolerance``
      (≈ mesh_stop_v_max).

    ``batch_size`` defaults large (512 patches per vmapped FFT
    batch; the reference's 32 suits smaller GPU launches) — it affects
    memory/speed only, never results.
    """

    residual_iterations: int = 2
    patch_size_zyx: tuple[int, int, int] = (10, 32, 32)
    minimum_patch_size_px: int = 4
    step_divisor: int = 2
    stride_zyx: Optional[tuple[int, int, int]] = None  # override patch//divisor
    peak_min_distance: int = 2
    peak_radius: int = 8
    batch_size: int = 512
    max_masked: float = 0.75
    min_peak_ratio: float = 1.2
    min_peak_sharpness: float = 1.2
    max_magnitude: float = 30.0
    max_deviation: float = 5.0
    max_local_z_displacement_px: float = 5.0
    normalization_epsilon: float = 1e-6
    relax_smoothness: float = 0.25
    relax_iterations: int = 200
    relax_tolerance: float = 1e-4

    def as_metadata(self) -> dict:
        """JSON-compatible config metadata (reference `as_metadata:40-46`)."""
        md = asdict(self)
        md["patch_size_zyx"] = [int(v) for v in self.patch_size_zyx]
        if self.stride_zyx is not None:
            md["stride_zyx"] = [int(v) for v in self.stride_zyx]
        return md

    def resolve_patch_and_stride(
        self, shape_zyx: tuple[int, int, int]
    ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
        """Patch clipped to the volume with the minimum-size floor; stride
        = patch // step_divisor unless explicitly overridden
        (reference `_resolve_patch_and_step:50-80`)."""
        patch = tuple(
            int(max(self.minimum_patch_size_px, min(s, p)))
            for s, p in zip(shape_zyx, self.patch_size_zyx)
        )
        if self.stride_zyx is not None:
            stride = tuple(
                int(max(1, min(st, p))) for st, p in zip(self.stride_zyx, patch)
            )
        else:
            stride = tuple(
                max(1, p // max(1, int(self.step_divisor))) for p in patch
            )
        return patch, stride


def _lattice_starts(size: int, patch: int, stride: int) -> np.ndarray:
    n = max(1, (size - patch) // stride + 1)
    return np.arange(n) * stride


@partial(
    jax.jit,
    static_argnames=(
        "patch_size", "strides", "batch_size",
        "peak_min_distance", "peak_radius", "max_masked",
        "normalization_epsilon",
    ),
)
def _patch_xcorr_flow(
    fixed: jnp.ndarray,
    moving: jnp.ndarray,
    *,
    patch_size: tuple[int, int, int],
    strides: tuple[int, int, int],
    batch_size: int = 512,
    peak_min_distance: int = 2,
    peak_radius: int = 8,
    max_masked: float = 0.75,
    normalization_epsilon: float = 1e-6,
):
    """Integer + subpixel flow per lattice patch via BATCHED FFT x-corr:
    lattice patches are gathered and cross-correlated ``batch_size`` at a
    time (vmapped FFTs — the analog of SOFIMA's batched
    ``JAXMaskedXCorrWithStatsCalculator``,
    `utils/sofima_registration.py:625`), bounding memory at
    O(batch_size · patch voxels) while keeping the FFTs batched on device.

    Per-patch statistics mirror the SOFIMA calculator's knobs:

    - ``peak_min_distance`` — periodic Chebyshev exclusion radius around
      the best peak when finding the second-best (peak ratio),
    - ``peak_radius`` — neighborhood radius whose mean correlation
      defines peak sharpness (best / neighborhood mean),
    - ``max_masked`` — patches whose fraction of exactly-zero voxels
      (warped-in border fill) exceeds this are invalidated,
    - ``normalization_epsilon`` — guard in the per-patch standardization.

    Returns (flow_zyx (P, 3), peak_ratio (P,), peak_sharpness (P,)) with
    flow = displacement of moving content relative to the reference patch."""
    if peak_radius <= peak_min_distance:
        # the sharpness ring (radius in (peak_min_distance, peak_radius])
        # would be empty and sharpness would degenerate to best/1e-12,
        # silently disabling (or inverting) the min_peak_sharpness gate
        raise ValueError(
            f"peak_radius ({peak_radius}) must exceed peak_min_distance "
            f"({peak_min_distance}) so the sharpness ring is non-empty"
        )
    pz, py, px = patch_size
    starts = [
        _lattice_starts(s, p, st)
        for s, p, st in zip(fixed.shape, patch_size, strides)
    ]
    grid = np.stack(
        np.meshgrid(*starts, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    grid = jnp.asarray(grid, jnp.int32)

    # patch-constant geometry, hoisted out of the batched kernel:
    # signed displacement per FFT bin and the plausible-displacement mask
    # (≤ quarter patch per axis)
    signed = [
        jnp.asarray(np.fft.fftfreq(n) * n, jnp.float32) for n in patch_size
    ]
    disp_ok = np.ones(patch_size, bool)
    for ax, n in enumerate(patch_size):
        shape = [1, 1, 1]
        shape[ax] = n
        c = np.abs(np.fft.fftfreq(n) * n).reshape(shape)
        disp_ok = disp_ok & (c <= n // 4)
    disp_ok = jnp.asarray(disp_ok)
    ramps = [
        jnp.arange(n, dtype=jnp.int32).reshape(
            [n if a == ax else 1 for a in range(3)]
        )
        for ax, n in enumerate(patch_size)
    ]

    def one_patch(start):
        f = jax.lax.dynamic_slice(fixed, start, patch_size)
        m = jax.lax.dynamic_slice(moving, start, patch_size)
        masked_frac = jnp.mean(
            ((f == 0.0) | (m == 0.0)).astype(jnp.float32)
        )
        f = f - jnp.mean(f)
        m = m - jnp.mean(m)
        f = f / (jnp.std(f) + normalization_epsilon)
        m = m / (jnp.std(m) + normalization_epsilon)
        from .fftutils import c_conj, c_mul, fftn_spec, ifftn_spec

        F = fftn_spec(f)
        M = fftn_spec(m)
        corr, _ = ifftn_spec(*c_mul(F, c_conj(M)))
        corr_m = jnp.where(disp_ok, corr, -jnp.inf)
        flat = jnp.argmax(corr_m)
        idx = jnp.stack(jnp.unravel_index(flat, corr.shape))
        peak = jnp.stack([signed[a][idx[a]] for a in range(3)])

        # peak ratio: best / second-best outside a periodic
        # peak_min_distance Chebyshev neighborhood of the best
        # (gather-free: coordinate-ramp compare)
        best = corr_m.reshape(-1)[flat]
        neigh = jnp.ones(patch_size, bool)
        ring = jnp.ones(patch_size, bool)
        for ax in range(3):
            n = patch_size[ax]
            d = jnp.abs(ramps[ax] - idx[ax])
            d = jnp.minimum(d, n - d)
            neigh = neigh & (d <= peak_min_distance)
            ring = ring & (d <= peak_radius)
        second = jnp.max(jnp.where(neigh, -jnp.inf, corr_m))
        ratio = best / jnp.maximum(second, 1e-12)
        ratio = jnp.where(second <= 0, jnp.inf, ratio)
        # degenerate tiny patch: the exclusion neighborhood covers the
        # whole patch (second = -inf over an all-masked array) — there is
        # no evidence the peak is distinct, so REJECT rather than pass
        # an inf ratio (review r3)
        ratio = jnp.where(jnp.isneginf(second), 0.0, ratio)
        ratio = jnp.where(masked_frac > max_masked, 0.0, ratio)

        # peak sharpness: best / mean correlation magnitude in the
        # peak_radius neighborhood (excluding the peak itself)
        ring_n = ring & ~neigh
        ring_sum = jnp.sum(jnp.where(ring_n, jnp.abs(corr), 0.0))
        ring_cnt = jnp.sum(ring_n.astype(jnp.float32))
        sharpness = best / jnp.maximum(
            ring_sum / jnp.maximum(ring_cnt, 1.0), 1e-12
        )
        # empty ring (patch ≤ exclusion neighborhood): no sharpness
        # evidence either — reject (same rationale as the ratio gate)
        sharpness = jnp.where(ring_cnt == 0, 0.0, sharpness)

        # 3-point parabolic subpixel refinement per axis
        sub = []
        for ax in range(3):
            def get(off):
                lin = 0
                for a in range(3):
                    i = (idx[a] + (off if a == ax else 0)) % patch_size[a]
                    lin = lin * patch_size[a] + i
                return corr.reshape(-1)[lin]

            cm, c0, cp = get(-1), get(0), get(1)
            denom = cm - 2 * c0 + cp
            delta = jnp.where(
                jnp.abs(denom) > 1e-12, 0.5 * (cm - cp) / denom, 0.0
            )
            sub.append(jnp.clip(delta, -0.5, 0.5))
        # x-corr peak is the "push"; flow (content displacement) = -push
        flow = -(peak + jnp.stack(sub))
        return flow, ratio, sharpness

    flows, ratios, sharps = jax.lax.map(
        one_patch, grid, batch_size=batch_size
    )
    lattice_shape = tuple(len(s) for s in starts)
    return (
        flows.reshape(*lattice_shape, 3),
        ratios.reshape(lattice_shape),
        sharps.reshape(lattice_shape),
    )


def _clean_flow(
    flow_zyx: np.ndarray,
    ratios: np.ndarray,
    sharps: np.ndarray,
    cfg: SofimaRegistrationConfig,
) -> np.ndarray:
    """Validity mask: peak ratio, peak sharpness, magnitude, per-channel
    deviation from the median of surviving vectors (reference
    ``flow_utils.clean_flow`` semantics, `sofima_registration.py:651-657`)."""
    mag = np.linalg.norm(flow_zyx, axis=-1)
    valid = (
        (ratios >= cfg.min_peak_ratio)
        & (sharps >= cfg.min_peak_sharpness)
        & (mag <= cfg.max_magnitude)
    )
    if valid.any():
        med = np.median(flow_zyx[valid], axis=0)
        dev = np.abs(flow_zyx - med).max(axis=-1)
        valid = valid & (dev <= cfg.max_deviation)
    return valid


@partial(jax.jit, static_argnames=("iterations",))
def _relax_field(
    flow: jnp.ndarray,  # (fz, fy, fx, 3) median-initialized
    measured: jnp.ndarray,
    valid: jnp.ndarray,  # (fz, fy, fx) bool
    *,
    smoothness: float,
    iterations: int,
    tolerance: float,
):
    """Jacobi relaxation of data + Laplacian smoothness: the explicit
    elastic-mesh analog. Valid sites are anchored to their measurement;
    invalid sites take the neighbor average."""
    w = valid[..., None].astype(jnp.float32)

    def neighbor_avg(f):
        total = jnp.zeros_like(f)
        count = jnp.zeros_like(f[..., :1])
        for ax in range(3):
            for off in (-1, 1):
                shifted = jnp.roll(f, off, axis=ax)
                # zero-flux boundary: clamp the roll at edges
                idx = jax.lax.broadcasted_iota(jnp.int32, f.shape[:3], ax)
                n = f.shape[ax]
                ok = ((idx - off) >= 0) & ((idx - off) < n)
                ok = ok[..., None].astype(jnp.float32)
                total = total + jnp.where(ok > 0, shifted, 0.0)
                count = count + ok[..., :1]
        # a site with NO neighbors (1x1x1 lattice) has no smoothness
        # evidence: pulling it toward an artificial zero would shrink a
        # valid measurement by smoothness/(1+smoothness) (review r3) —
        # use the site's own value (pure data term) instead
        return jnp.where(count > 0, total / jnp.maximum(count, 1.0), f)

    def cond(carry):
        f, delta, it = carry
        return (delta > tolerance) & (it < iterations)

    def body(carry):
        f, _, it = carry
        avg = neighbor_avg(f)
        data_weight = w / (w + smoothness)
        new = data_weight * measured + (1.0 - data_weight) * avg
        delta = jnp.max(jnp.abs(new - f))
        return new, delta, it + 1

    out, _, _ = jax.lax.while_loop(cond, body, (flow, jnp.float32(jnp.inf), 0))
    return out


def _compose_flow_fields_same_grid(
    total_xyz: np.ndarray,
    residual_xyz: np.ndarray,
    stride_zyx: np.ndarray,
) -> np.ndarray:
    """total'(r) = residual(r) + total(r + residual(r)) on the shared
    lattice (reference `_compose_flow_fields_same_grid:151-214`)."""
    fz, fy, fx = total_xyz.shape[1:]
    zz, yy, xx = jnp.meshgrid(
        jnp.arange(fz, dtype=jnp.float32),
        jnp.arange(fy, dtype=jnp.float32),
        jnp.arange(fx, dtype=jnp.float32),
        indexing="ij",
    )
    # residual displacement in lattice units (channels X,Y,Z ↔ axes x,y,z)
    rz = residual_xyz[2] / stride_zyx[0]
    ry = residual_xyz[1] / stride_zyx[1]
    rx = residual_xyz[0] / stride_zyx[2]
    coords = [zz + rz, yy + ry, xx + rx]
    sampled = jnp.stack(
        [
            jax.scipy.ndimage.map_coordinates(
                jnp.asarray(total_xyz[c]), coords, order=1, mode="nearest"
            )
            for c in range(3)
        ]
    )
    return np.asarray(jnp.asarray(residual_xyz) + sampled, np.float32)


def estimate_sofima_flow_field_xyz_px(
    reference: np.ndarray,
    moving: np.ndarray,
    config: SofimaRegistrationConfig = SofimaRegistrationConfig(),
) -> tuple[np.ndarray, dict]:
    """Estimate the residual deformable flow of ``moving`` (already
    affine-initialized into the reference frame) relative to ``reference``.

    Returns (flow_field (3, fz, fy, fx) float32 with channels X, Y, Z, and a
    metadata dict with the datastore attribute contract)."""
    from ..ops.warp import (
        _affine_flow_warp_core,
        _flow_warp_separable_core,
        _separable_flow_bounds,
    )

    cfg = config
    patch, stride = cfg.resolve_patch_and_stride(reference.shape)
    ref_j = jnp.asarray(reference, jnp.float32)

    starts = [
        _lattice_starts(s, p, st)
        for s, p, st in zip(reference.shape, patch, stride)
    ]
    lattice_shape = tuple(len(s) for s in starts)
    box_start_zyx = [float(s[0] + p / 2.0) for s, p in zip(starts, patch)]

    total_xyz = np.zeros((3, *lattice_shape), np.float32)
    valid_count = 0
    # moving and the re-warped intermediate stay device-resident across the
    # residual passes; only the lattice-sized flow vectors cross to host
    moving_j = jnp.asarray(moving, jnp.float32)
    current = moving_j

    meta_common = dict(
        map_stride_zyx_px=[float(s) for s in stride],
        map_box_start_xyz_px=[box_start_zyx[2], box_start_zyx[1], box_start_zyx[0]],
        map_box_size_xyz_px=[
            float((lattice_shape[2] - 1) * stride[2] + 1),
            float((lattice_shape[1] - 1) * stride[1] + 1),
            float((lattice_shape[0] - 1) * stride[0] + 1),
        ],
        reference_shape_zyx_px=[int(v) for v in reference.shape],
        moving_shape_zyx_px=[int(v) for v in moving.shape],
    )

    best_valid_count = 0
    for iteration in range(max(1, cfg.residual_iterations)):
        flow_zyx, ratios, sharps = _patch_xcorr_flow(
            ref_j,
            current,
            patch_size=patch,
            strides=stride,
            batch_size=int(cfg.batch_size),
            peak_min_distance=int(cfg.peak_min_distance),
            peak_radius=int(cfg.peak_radius),
            max_masked=float(cfg.max_masked),
            normalization_epsilon=float(cfg.normalization_epsilon),
        )
        flow_zyx = np.asarray(flow_zyx)
        ratios = np.asarray(ratios)
        sharps = np.asarray(sharps)
        valid = _clean_flow(flow_zyx, ratios, sharps, cfg)
        valid_count = int(valid.sum())
        # status reflects the BEST pass: a productive first pass whose
        # residual re-estimate converges to zero fresh vectors is a
        # success, not "no_valid_vectors" (review r3)
        best_valid_count = max(best_valid_count, valid_count)
        if valid_count == 0:
            break
        med = np.median(flow_zyx[valid], axis=0)
        init = np.broadcast_to(med, flow_zyx.shape).astype(np.float32).copy()
        relaxed = np.array(
            _relax_field(
                jnp.asarray(init),
                jnp.asarray(flow_zyx.astype(np.float32)),
                jnp.asarray(valid),
                smoothness=cfg.relax_smoothness,
                iterations=cfg.relax_iterations,
                tolerance=cfg.relax_tolerance,
            )
        )
        # axial stabilization: Z clipped to median ± the local limit
        # (reference `_stabilize_axial_flow_component:81-148`)
        z_med = float(np.median(relaxed[..., 0]))
        relaxed[..., 0] = np.clip(
            relaxed[..., 0],
            z_med - cfg.max_local_z_displacement_px,
            z_med + cfg.max_local_z_displacement_px,
        )
        residual_xyz = np.stack(
            [relaxed[..., 2], relaxed[..., 1], relaxed[..., 0]]
        ).astype(np.float32)
        if iteration == 0:
            total_xyz = residual_xyz
        else:
            total_xyz = _compose_flow_fields_same_grid(
                total_xyz, residual_xyz, np.asarray(stride, np.float64)
            )
        if iteration + 1 < cfg.residual_iterations:
            ref_shape = tuple(int(v) for v in reference.shape)
            # identity affine + bounded flow: the separable roll-blend
            # warp replaces the per-voxel trilinear gather whenever the
            # shapes line up (ops/warp.py:_flow_warp_separable_core)
            k_ranges = (
                _separable_flow_bounds(
                    np.eye(3, dtype=np.float32),
                    np.zeros(3, np.float32),
                    total_xyz,
                    ref_shape,
                )
                if tuple(moving_j.shape) == ref_shape
                else None
            )
            if k_ranges is not None:
                current = _flow_warp_separable_core(
                    moving_j,
                    jnp.asarray(total_xyz),
                    jnp.ones(3, jnp.float32),
                    jnp.zeros(3, jnp.float32),
                    jnp.asarray(stride, jnp.float32),
                    jnp.asarray(box_start_zyx, jnp.float32),
                    k_ranges=k_ranges,
                    out_shape=ref_shape,
                )
            else:
                current = _affine_flow_warp_core(
                    moving_j,
                    jnp.asarray(total_xyz),
                    jnp.eye(3, dtype=jnp.float32),
                    jnp.zeros(3, jnp.float32),
                    jnp.asarray(stride, jnp.float32),
                    jnp.asarray(box_start_zyx, jnp.float32),
                    reference_shape=ref_shape,
                )

    meta = dict(meta_common)
    meta["sofima_status"] = "ok" if best_valid_count else "no_valid_vectors"
    meta["valid_flow_vectors"] = best_valid_count
    return total_xyz.astype(np.float32), meta
