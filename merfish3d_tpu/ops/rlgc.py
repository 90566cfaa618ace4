"""Richardson-Lucy Gradient-Consensus (RLGC) deconvolution.

JAX reimplementation of the reference RLGC solver
(reference `utils/rlgc.py:507-768`, Manton & York gradient-consensus):

1. Symmetric linear-convolution padding to 2,3-smooth FFT sizes.
2. Per-iteration 50:50 binomial photon split (JAX PRNG; iteration folded
   into the key).
3. Forward model via batched 3D rFFT convolution.
4. Split-KLD early stopping: restore the previous reconstruction if either
   split KLD increased (safe mode).
5. Consensus-gated multiplicative update (elementwise; XLA fuses this with
   the inverse-FFT epilogue, replacing the reference's CUDA
   ``filter_update`` ElementwiseKernel `rlgc.py:23-31`).
6. Boundary re-symmetrization each iteration, plus updated-fraction and
   max-relative-delta stops.

The whole iteration loop is a single jitted ``lax.while_loop`` so the device
never round-trips to host between iterations; batching over readout bits is
a sequential ``lax.map`` scan over the leading axis (`rlgc_batch`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..device import scale_budget
from .fftutils import (
    axis_linear_fft_padding,
    c_conj,
    c_mul,
    enforce_symmetric_boundary,
    fft_conv_full,
    fft_conv_spec,
    fftn_spec,
    linear_fft_pad_width,
    observed_region_mask,
    observed_region_mask_device,
    pad_psf,
    pad_symmetric,
    remove_padding_zyx,
)

_EPS_KLD = 1e-4


def _binomial_half(key: jnp.ndarray, counts: jnp.ndarray) -> jnp.ndarray:
    """Fast Binomial(n, 1/2) sampler for photon-count splitting.

    ``jax.random.binomial`` lowers to per-element rejection sampling, a
    data-dependent loop per voxel. This sampler is exact for n <= 32 — popcount of n masked uniform random bits
    IS a Binomial(n, 1/2) draw — and uses the rounded normal approximation
    (mean n/2, var n/4) beyond, where it is statistically indistinguishable
    for the split-KLD stopping rule (SURVEY.md §7: validate stopping
    statistically, not bitwise).
    """
    k_bits, k_norm = jax.random.split(key)
    n = counts.astype(jnp.int32)
    bits = jax.random.bits(k_bits, n.shape, jnp.uint32)
    n_small = jnp.clip(n, 0, 32).astype(jnp.uint32)
    mask = jnp.where(
        n_small >= 32,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << n_small) - jnp.uint32(1),
    )
    exact = jax.lax.population_count(bits & mask).astype(jnp.float32)
    nf = n.astype(jnp.float32)
    z = jax.random.normal(k_norm, n.shape, jnp.float32)
    approx = jnp.clip(jnp.round(0.5 * nf + jnp.sqrt(0.25 * nf) * z), 0.0, nf)
    return jnp.where(n <= 32, exact, approx)


def _kl_div(p: jnp.ndarray, q: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Masked KLD with eps smoothing (reference `rlgc.py:389-419`)."""
    p = (p + _EPS_KLD) * mask
    q = (q + _EPS_KLD) * mask
    p = p / jnp.sum(p)
    q = q / jnp.sum(q)
    kld = p * (jnp.log(p) - jnp.log(q))
    kld = jnp.where(jnp.isnan(kld), 0.0, kld)
    return jnp.sum(kld)


def _prepare_solve(shape, psf, pad_width):
    """Shared per-solve constants: observed-region mask, interior pixel
    count, the three resident OTF pairs (forward, adjoint, consensus) and
    the clamped Hᵀ·mask normalization (reference `rlgc.py:598-601`)."""
    mask = observed_region_mask_device(shape, pad_width)
    num_pixels = float(np.prod([s - b - a for s, (b, a) in zip(shape, pad_width)]))

    padded_psf = pad_psf(psf, shape)
    # full-spectrum OTFs as (real, imag) float32 pairs: packed adjoint/pair
    # convolutions ride ONE transform (real kernel ⇒ conv(a+ib, k) =
    # conv(a,k) + i·conv(b,k)).
    otf_full = fftn_spec(padded_psf)
    otf_t_full = c_conj(otf_full)
    otf2_full = c_mul(otf_full, otf_t_full)
    update_norm = jnp.maximum(fft_conv_full(mask, otf_t_full), 1e-6)

    return mask, num_pixels, otf_full, otf_t_full, otf2_full, update_norm


def _ratios_klds(Hu, split1, split2, mask):
    """Per-volume update ratios + split KLDs for one iteration. XLA fuses
    the elementwise chain with its reductions."""
    kld1 = _kl_div(Hu, split1, mask)
    kld2 = _kl_div(Hu, split2, mask)
    denom = 0.5 * (Hu + 1e-12)
    ratio1 = mask * (split1 / denom)
    ratio2 = mask * (split2 / denom)
    return ratio1, ratio2, kld1, kld2


def _split_ht(gr, gi, update_norm):
    """Neutralize ht where the adjoint has no mask support: deep in the
    padding update_norm = Hᵀ(mask) decays to its 1e-6 clamp (reference
    `rlgc.py:598-601`), so g/norm there is pure FFT rounding error
    amplified by up to 1e6 (with bf16 spectra it reached ±8e3 and its
    square leaked through the consensus convolution into border voxels,
    tripping the split-KLD stop on the first iteration). ht := 1 is the
    no-op update and contributes (ht-1) = 0 to the consensus."""
    ht1 = jnp.where(update_norm >= 1e-3, gr / update_norm, 1.0)
    ht2 = jnp.where(update_norm >= 1e-3, gi / update_norm, 1.0)
    return ht1, ht2


# The split-KLD stopping rule compares KLDs measured under DIFFERENT
# random binomial splits each iteration; on dim spot-sparse volumes the
# between-split variance exceeds the early-iteration improvement, so the
# restore fires at iteration 1-2 with ~coin-flip probability and the
# solve returns the FLAT mean init (found r5: 9/16 readout bits of a
# production-geometry tile deconvolved to their mean — the reference's
# identical rule, `rlgc.py:641-660`, has the same failure mode on this
# regime; its published data is dense enough to never show it). Suppress
# both the restore and the convergence exits until this many iterations
# have run: the first updates from a flat init are improvements in
# expectation, and a forced minimum costs ~3 iterations on data that
# would legitimately stop early.
MIN_STOP_ITERS = 3


def _apply_update(
    consensus,
    recon,
    prev_recon,
    ht,
    should_restore,
    klds,
    prev_klds,
    it,
    *,
    pad_width,
    mask,
    num_pixels,
    limit,
    max_delta,
):
    """Consensus-gated multiplicative update + branchless restore +
    convergence stats for ONE volume; returns the new carry slice
    (recon, prev, kld1, kld2, it, done)."""
    kld1, kld2 = klds
    prev_kld1, prev_kld2 = prev_klds
    # consensus-gated multiplicative update (`rlgc.py:23-31,693`)
    updated = jnp.where(consensus < 0, recon, recon * ht)
    updated = enforce_symmetric_boundary(updated, pad_width)

    num_updated = jnp.sum((consensus >= 0) * mask)
    updated_fraction = num_updated / num_pixels
    obs_new = updated * mask
    obs_old = recon * mask
    recon_max = jnp.maximum(jnp.max(obs_new), 1e-12)
    max_rel_delta = jnp.max(jnp.abs(obs_new - obs_old) / recon_max)
    converged = (
        (updated_fraction < limit) | (max_rel_delta < max_delta)
    ) & (it + 1 >= MIN_STOP_ITERS)

    new_recon = jnp.where(should_restore, prev_recon, updated)
    new_prev = jnp.where(should_restore, prev_recon, recon)
    return (
        new_recon,
        new_prev,
        jnp.where(should_restore, prev_kld1, kld1),
        jnp.where(should_restore, prev_kld2, kld2),
        it + jnp.where(should_restore, jnp.int32(0), jnp.int32(1)),
        should_restore | converged,
    )


@partial(
    jax.jit,
    static_argnames=("pad_width", "safe_mode", "limit", "max_delta", "max_iters"),
)
def _rlgc_core(
    observed: jnp.ndarray,
    psf: jnp.ndarray,
    key: jnp.ndarray,
    *,
    pad_width,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
):
    """Jitted RLGC solve on a pre-padded observed image. Returns
    (recon_padded, num_iters)."""
    shape = observed.shape
    mask, num_pixels, otf_full, otf_t_full, otf2_full, update_norm = _prepare_solve(
        shape, psf, pad_width
    )

    init_recon = jnp.full(
        shape, jnp.sum(observed * mask) / num_pixels, dtype=jnp.float32
    )
    observed_int = observed.astype(jnp.int32)

    def cond(carry):
        _, _, _, _, it, done = carry
        return jnp.logical_and(~done, it < max_iters)

    def body(carry):
        recon, prev_recon, prev_kld1, prev_kld2, it, _ = carry
        iter_key = jax.random.fold_in(key, it)
        split1 = _binomial_half(iter_key, observed_int)
        split2 = observed - split1

        Hu = fft_conv_full(recon, otf_full)
        ratio1, ratio2, kld1, kld2 = _ratios_klds(Hu, split1, split2, mask)
        if safe_mode:
            should_restore = (kld1 > prev_kld1) | (kld2 > prev_kld2)
        else:
            should_restore = (kld1 > prev_kld1) & (kld2 > prev_kld2)
        should_restore = should_restore & (it >= MIN_STOP_ITERS)

        # Branchless restore: the update is always computed and the restore
        # is an elementwise select, with no conditional dataflow around the
        # FFTs — the same cost profile as the reference, which also
        # evaluates the KLDs before deciding (`rlgc.py:627-660`).
        gr, gi = fft_conv_spec(ratio1, ratio2, otf_t_full)
        ht1, ht2 = _split_ht(gr, gi, update_norm)
        ht = ht1 + ht2
        consensus = fft_conv_full((ht1 - 1.0) * (ht2 - 1.0), otf2_full)
        return _apply_update(
            consensus,
            recon,
            prev_recon,
            ht,
            should_restore,
            (kld1, kld2),
            (prev_kld1, prev_kld2),
            it,
            pad_width=pad_width,
            mask=mask,
            num_pixels=num_pixels,
            limit=limit,
            max_delta=max_delta,
        )

    carry = (
        init_recon,
        init_recon,
        jnp.float32(jnp.inf),
        jnp.float32(jnp.inf),
        jnp.int32(0),
        jnp.bool_(False),
    )
    recon, _, _, _, num_iters, _ = jax.lax.while_loop(cond, body, carry)
    return recon, num_iters


def pairing_enabled() -> bool:
    """Solve batched volumes two-slots-at-a-time with every FFT
    convolution packed as a (real, imag) pair (`_rlgc_queue_core`)?
    Static at trace time.

    Two same-PSF volumes share 4 packed convolutions per iteration instead
    of paying for 6, with per-volume math unchanged (the pack is exact:
    conv(a + i·b, k) = conv(a, k) + i·conv(b, k) for the real RLGC
    kernels). ``MERFISH3D_RLGC_PAIR=0|1`` overrides (default: on).
    """
    import os

    return os.environ.get("MERFISH3D_RLGC_PAIR", "1") != "0"


def _rlgc_queue_core(
    observed: jnp.ndarray,
    psf: jnp.ndarray,
    keys: jnp.ndarray,
    *,
    pad_width,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
):
    """RLGC solve of a WHOLE batch of pre-padded volumes (≥2, shared PSF)
    in ONE ``while_loop``, two volume slots at a time with every FFT
    convolution packed as a (real, imag) pair.

    Each iteration runs 4 packed pair convolutions for both slots —
    forward (Hu_a, Hu_b), one adjoint pair per slot, consensus
    (c_a, c_b) — where two independent solves would pay 2×3. Per-slot
    updates, split-KLD stopping and convergence are untouched single-core
    math. When a slot's volume converges it RETIRES: its final recon and
    iteration count land in the output stacks and the slot reloads the
    next queued volume from HBM, so mismatched per-volume iteration
    counts cost nothing (a fixed (a,b) pairing wastes the iteration-count
    difference; the queue keeps both slots hot for ceil(total_iters/2)
    pair iterations + a one-volume tail).

    Bookkeeping rides idempotent unconditional writes: every iteration
    writes slot recon/iters at the slot's volume index — after
    retirement the frozen carry rewrites the final value, so no
    conditional dataflow enters the loop body (selects are free).

    Returns (recon stack (B, ...), num_iters (B,)).
    """
    B = observed.shape[0]
    shape = observed.shape[1:]
    mask, num_pixels, otf_full, otf_t_full, otf2_full, update_norm = _prepare_solve(
        shape, psf, pad_width
    )
    # per-volume flat-field init means, one vectorized pass over the stack
    means = (
        jnp.sum(observed * mask[None], axis=(1, 2, 3)) / num_pixels
    ).astype(jnp.float32)

    def load(vol_idx):
        return jax.lax.dynamic_index_in_dim(observed, vol_idx, keepdims=False)

    def body(carry):
        (out_stack, iters_out, recon, prev_recon, prev_kld1, prev_kld2,
         it, vol_idx, slot_active, next_idx) = carry

        obs = [load(vol_idx[v]) for v in range(2)]
        splits = []
        for v in range(2):
            k = jax.random.fold_in(keys[vol_idx[v]], it[v])
            s1 = _binomial_half(k, obs[v].astype(jnp.int32))
            splits.append((s1, obs[v] - s1))

        Hu_a, Hu_b = fft_conv_spec(recon[0], recon[1], otf_full)

        per_vol = []
        for v, Hu in enumerate((Hu_a, Hu_b)):
            r1, r2, kld1, kld2 = _ratios_klds(Hu, splits[v][0], splits[v][1], mask)
            if safe_mode:
                restore = (kld1 > prev_kld1[v]) | (kld2 > prev_kld2[v])
            else:
                restore = (kld1 > prev_kld1[v]) & (kld2 > prev_kld2[v])
            restore = restore & (it[v] >= MIN_STOP_ITERS)
            gr, gi = fft_conv_spec(r1, r2, otf_t_full)
            ht1, ht2 = _split_ht(gr, gi, update_norm)
            per_vol.append((ht1 + ht2, (ht1 - 1.0) * (ht2 - 1.0),
                            restore, kld1, kld2))

        cons_a, cons_b = fft_conv_spec(per_vol[0][1], per_vol[1][1], otf2_full)

        new = []
        for v, consensus in enumerate((cons_a, cons_b)):
            ht, _, restore, kld1, kld2 = per_vol[v]
            out = _apply_update(
                consensus,
                recon[v],
                prev_recon[v],
                ht,
                restore,
                (kld1, kld2),
                (prev_kld1[v], prev_kld2[v]),
                it[v],
                pad_width=pad_width,
                mask=mask,
                num_pixels=num_pixels,
                limit=limit,
                max_delta=max_delta,
            )
            # freeze an inactive slot: its carry rides unchanged (and its
            # output writes below stay idempotent)
            old = (recon[v], prev_recon[v], prev_kld1[v], prev_kld2[v],
                   it[v], jnp.bool_(True))
            new.append(tuple(
                jnp.where(slot_active[v], n, o) for n, o in zip(out, old)
            ))

        # publish state at the slot's CURRENT index (pre-reload):
        # idempotent after retirement, final at the retire iteration
        for v in range(2):
            out_stack = jax.lax.dynamic_update_index_in_dim(
                out_stack, new[v][0], vol_idx[v], 0
            )
            iters_out = iters_out.at[vol_idx[v]].set(new[v][4])

        # retire + reload: a converged (or iteration-capped) slot takes the
        # next queued volume; simultaneous retires take consecutive indices
        new_vol_idx, new_active, new_state = [], [], []
        take = next_idx
        for v in range(2):
            retire = slot_active[v] & (new[v][5] | (new[v][4] >= max_iters))
            has_next = retire & (take < B)
            idx_v = jnp.where(has_next, take, vol_idx[v])
            take = take + has_next.astype(jnp.int32)
            new_vol_idx.append(idx_v)
            new_active.append(
                jnp.where(retire, has_next, slot_active[v])
            )
            init_v = jnp.broadcast_to(means[idx_v], shape)
            reload = has_next
            new_state.append((
                jnp.where(reload, init_v, new[v][0]),
                jnp.where(reload, init_v, new[v][1]),
                jnp.where(reload, jnp.float32(jnp.inf), new[v][2]),
                jnp.where(reload, jnp.float32(jnp.inf), new[v][3]),
                jnp.where(reload, jnp.int32(0), new[v][4]),
            ))

        stack = lambda i: jnp.stack([new_state[0][i], new_state[1][i]])
        return (
            out_stack,
            iters_out,
            stack(0),
            stack(1),
            stack(2),
            stack(3),
            stack(4),
            jnp.stack(new_vol_idx),
            jnp.stack(new_active),
            take,
        )

    init_recon = jnp.broadcast_to(
        means[:2, None, None, None], (2, *shape)
    ).astype(jnp.float32)
    carry = (
        jnp.zeros_like(observed),
        jnp.zeros((B,), jnp.int32),
        init_recon,
        init_recon,
        jnp.full((2,), jnp.inf, jnp.float32),
        jnp.full((2,), jnp.inf, jnp.float32),
        jnp.zeros((2,), jnp.int32),
        jnp.arange(2, dtype=jnp.int32),
        jnp.ones((2,), bool),
        jnp.int32(2),
    )
    carry = jax.lax.while_loop(lambda c: jnp.any(c[8]), body, carry)
    return carry[0], carry[1]


def rlgc(
    image: np.ndarray,
    psf: np.ndarray,
    *,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    pad_yx: bool = True,
) -> np.ndarray:
    """RLGC deconvolve one 3D volume; returns float32 of the input shape.

    Single-volume convenience wrapper (reference `rlgc.py:507-768`).
    For throughput, prefer :func:`rlgc_batch`.
    """
    image = np.asarray(image, dtype=np.float32)
    psf = np.asarray(psf, dtype=np.float32)
    if psf.ndim == 2:
        psf = psf[None]
    pad_width = linear_fft_pad_width(image.shape, psf.shape, pad_yx=pad_yx)
    padded = pad_symmetric(jnp.asarray(image), pad_width)
    key = jax.random.PRNGKey(seed)
    recon, _ = _rlgc_core(
        padded,
        jnp.asarray(psf),
        key,
        pad_width=pad_width,
        safe_mode=safe_mode,
        limit=limit,
        max_delta=max_delta,
        max_iters=max_iters,
    )
    out = remove_padding_zyx(recon, pad_width)
    return np.asarray(out, dtype=np.float32)


@partial(
    jax.jit,
    static_argnames=(
        "pad_width", "safe_mode", "limit", "max_delta", "max_iters", "pair",
    ),
)
def _rlgc_batch_core(
    padded: jnp.ndarray,
    psf: jnp.ndarray,
    keys: jnp.ndarray,
    *,
    pad_width,
    safe_mode: bool,
    limit: float,
    max_delta: float,
    max_iters: int,
    pair: bool = False,
):
    kw = dict(
        pad_width=pad_width,
        safe_mode=safe_mode,
        limit=limit,
        max_delta=max_delta,
        max_iters=max_iters,
    )
    fn = partial(_rlgc_core, **kw)
    # lax.map (sequential scan), NOT vmap: vmap multiplies the live
    # working set by the batch; the scan keeps ONE volume's (or one
    # pair's) FFT intermediates live in a single program.
    n = padded.shape[0]
    if not pair or n < 2:
        return jax.lax.map(lambda args: fn(args[0], psf, args[1]), (padded, keys))

    # two slots, packed convolutions, retire-and-reload over the whole
    # batch in one while_loop (`_rlgc_queue_core`)
    return _rlgc_queue_core(padded, psf, keys, **kw)


def rlgc_batch(
    images: np.ndarray,
    psf: np.ndarray,
    *,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    out: str = "host",
) -> np.ndarray:
    """Deconvolve a batch of same-shaped volumes (e.g. all readout bits of a
    tile) in one device program. Per-volume seeds are derived from
    ``seed`` by index, matching the reference's per-tile RNG seed offsets
    (`rlgc.py:996`).

    ``out="device"`` returns the f32 result as a device array so downstream
    device consumers (the U-FISH predictor) chain without a device→host→
    device bounce — a full readout-bit batch is hundreds of MB."""
    # keep integer camera data narrow until it reaches the device: a u16
    # chunk uploads at half the bytes of f32; the cast to f32 is exact and
    # runs on device
    images = np.asarray(images)
    if images.dtype != np.uint16:
        images = images.astype(np.float32, copy=False)
    psf = np.asarray(psf, dtype=np.float32)
    if psf.ndim == 2:
        psf = psf[None]
    pad_width = linear_fft_pad_width(images.shape[1:], psf.shape)
    padded = jax.vmap(
        lambda im: pad_symmetric(im.astype(jnp.float32), pad_width)
    )(jnp.asarray(images))
    keys = jax.vmap(jax.random.PRNGKey)(seed + np.arange(images.shape[0]))
    recon, _ = _rlgc_batch_core(
        padded,
        jnp.asarray(psf),
        keys,
        pad_width=pad_width,
        safe_mode=safe_mode,
        limit=limit,
        max_delta=max_delta,
        max_iters=max_iters,
        pair=pairing_enabled(),
    )
    result = jax.vmap(lambda r: remove_padding_zyx(r, pad_width))(recon)
    if out == "device":
        return result
    return np.asarray(result, dtype=np.float32)


def rlgc_diagnostics(
    image: np.ndarray,
    psf: np.ndarray,
    *,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    logger=None,
) -> np.ndarray:
    """RLGC with per-iteration structured diagnostics (reference
    `rlgc.py:616-760` logging channel: iteration, KLDs, update min/max,
    updated fraction, stop reason). Runs the loop host-side with a jitted
    per-iteration step; numerics match :func:`rlgc` up to the host/device
    loop boundary."""
    import logging

    log = logger or logging.getLogger("merfish3d_tpu.rlgc")
    image = np.asarray(image, dtype=np.float32)
    psf = np.asarray(psf, dtype=np.float32)
    if psf.ndim == 2:
        psf = psf[None]
    pad_width = linear_fft_pad_width(image.shape, psf.shape)
    padded = pad_symmetric(jnp.asarray(image), pad_width)
    shape = padded.shape
    # iota-built on device: a host mask constant closed over by the jitted
    # iteration would be embedded in the program (~212 MB at production
    # shapes)
    mask = observed_region_mask_device(shape, pad_width)
    num_pixels = float(np.prod([s - b - a for s, (b, a) in zip(shape, pad_width)]))
    padded_psf = pad_psf(jnp.asarray(psf), shape)
    # same full-spectrum pair transforms as `_rlgc_core` so the
    # diagnostics channel reports production numerics exactly
    otf_full = fftn_spec(padded_psf)
    otf_t_full = c_conj(otf_full)
    otf2_full = c_mul(otf_full, otf_t_full)
    update_norm = jnp.maximum(fft_conv_full(mask, otf_t_full), 1e-6)
    observed_int = padded.astype(jnp.int32)

    # every array travels as an explicit argument — closure-captured
    # concrete arrays become constants embedded in the program
    @jax.jit
    def iteration(recon, key, padded, observed_int, mask, otf_full,
                  otf_t_full, otf2_full, update_norm):
        split1 = _binomial_half(key, observed_int)
        split2 = padded - split1
        Hu = fft_conv_full(recon, otf_full)
        kld1 = _kl_div(Hu, split1, mask)
        kld2 = _kl_div(Hu, split2, mask)
        denom = 0.5 * (Hu + 1e-12)
        ratio1 = mask * (split1 / denom)
        ratio2 = mask * (split2 / denom)
        gr, gi = fft_conv_spec(ratio1, ratio2, otf_t_full)
        ht1, ht2 = _split_ht(gr, gi, update_norm)
        ht = ht1 + ht2
        consensus = fft_conv_full((ht1 - 1.0) * (ht2 - 1.0), otf2_full)
        new_recon = jnp.where(consensus < 0, recon, recon * ht)
        new_recon = enforce_symmetric_boundary(new_recon, pad_width)
        updated_fraction = jnp.sum((consensus >= 0) * mask) / num_pixels
        obs_new = new_recon * mask
        obs_old = recon * mask
        recon_max = jnp.maximum(jnp.max(obs_new), 1e-12)
        max_rel = jnp.max(jnp.abs(obs_new - obs_old) / recon_max)
        return new_recon, kld1, kld2, jnp.min(ht), jnp.max(ht), updated_fraction, max_rel

    key = jax.random.PRNGKey(seed)
    recon = jnp.full(shape, jnp.sum(padded * mask) / num_pixels, jnp.float32)
    prev = recon
    prev_kld1 = prev_kld2 = np.inf
    for it in range(max_iters):
        new_recon, kld1, kld2, ht_min, ht_max, frac, max_rel = iteration(
            recon, jax.random.fold_in(key, it), padded, observed_int,
            mask, otf_full, otf_t_full, otf2_full, update_norm,
        )
        kld1, kld2 = float(kld1), float(kld2)
        restore = (
            (kld1 > prev_kld1) or (kld2 > prev_kld2)
            if safe_mode
            else (kld1 > prev_kld1) and (kld2 > prev_kld2)
        )
        if restore:
            log.info(
                "stop=restore_previous_recon best_iteration=%d kld_split1=%.6f "
                "prev_kld_split1=%.6f kld_split2=%.6f prev_kld_split2=%.6f",
                max(it - 1, 0), kld1, prev_kld1, kld2, prev_kld2,
            )
            recon = prev
            break
        prev, recon = recon, new_recon
        prev_kld1, prev_kld2 = kld1, kld2
        frac, max_rel = float(frac), float(max_rel)
        log.info(
            "iteration=%03d kld_split1=%.6f kld_split2=%.6f update_min=%.3f "
            "update_max=%.3f updated_fraction=%.5f max_relative_delta=%.5f",
            it + 1, kld1, kld2, float(ht_min), float(ht_max), frac, max_rel,
        )
        if frac < limit:
            log.info("stop=limit iteration=%03d updated_fraction=%.5f", it + 1, frac)
            break
        if max_rel < max_delta:
            log.info(
                "stop=max_delta iteration=%03d max_relative_delta=%.5f",
                it + 1, max_rel,
            )
            break
    out = remove_padding_zyx(recon, pad_width)
    return np.asarray(out, dtype=np.float32)


# Memory budgets, each given at the 16 GiB reference limit and scaled to
# the device (`device.scale_budget`). One solve keeps ~10 padded f32
# buffers live, counting the complex FFT intermediates; at the reference
# limit (48, 1152, 1152) (~64M padded voxels) fits and (48, 2304, 2304)
# (~255M) does not, and XLA plans memory statically, so there is no
# runtime OOM-retry to fall back on.
DEFAULT_BUDGET_PADDED_VOXELS = 9.0e7
# `rlgc_batch` runs a sequential lax.map scan, so the live footprint is
# the input+output batch stacks (2·B padded volumes) plus ONE solve's
# working set (~10 padded f32 buffers): ~2.2e9 f32 (~8.8 GB) at the
# reference limit, leaving room for the datastore prefetch buffers.
SCAN_TOTAL_F32_BUDGET = 2.2e9
_SCAN_WORKING_SET_BUFFERS = 10.0
# The paired solve (`_rlgc_queue_core`) carries TWO volumes' recon/prev/
# split/ht buffers across its packed convolutions; the packed FFT
# intermediates themselves are the same size as the single solve's.
# ~6 extra persistent padded-volume buffers on top of the single solve's 10.
_PAIR_WORKING_SET_BUFFERS = 16.0
MAX_SCAN_BATCH = 32


def max_vmap_batch(
    image_shape,
    psf_shape,
    budget_padded_voxels: "float | None" = None,
) -> int:
    """How many volumes of this shape fit one `rlgc_batch` scan.

    Passing ``budget_padded_voxels`` keeps the legacy total-padded-voxel
    semantics (used by tests probing the budget arithmetic)."""
    nz, ny, nx = (int(v) for v in image_shape)
    pz = nz + sum(axis_linear_fft_padding(nz, psf_shape[0]))
    py = ny + sum(axis_linear_fft_padding(ny, psf_shape[1]))
    px = nx + sum(axis_linear_fft_padding(nx, psf_shape[2]))
    padded = pz * py * px
    if budget_padded_voxels is not None:
        return max(1, int(budget_padded_voxels // padded))
    ws = _PAIR_WORKING_SET_BUFFERS if pairing_enabled() else _SCAN_WORKING_SET_BUFFERS
    b = int((scale_budget(SCAN_TOTAL_F32_BUDGET) / padded - ws) // 2.0)
    return max(1, min(b, MAX_SCAN_BATCH))


def auto_crop_yx(
    image_shape,
    psf_shape,
    budget_padded_voxels: "float | None" = None,
) -> int:
    """Largest lateral crop whose PADDED solve fits the memory budget
    (default: :data:`DEFAULT_BUDGET_PADDED_VOXELS` scaled to the device).

    Replaces the reference's OOM-retry shrink loop (`rlgc.py:1152-1171`
    catches GPU OOM and reduces ``crop_yx`` by 128): XLA memory planning
    is static, so the tile size is chosen up front from the padded-FFT
    working-set size instead of reactively.

    The budgeted extent per lateral axis is crop + 2·PSF-support — the
    discarded halo `chunked_rlgc` adds around each retained tile. There
    is no runtime OOM fallback, so the budget must hold for the tile
    actually solved, not just the retained region (review r3).
    """
    if budget_padded_voxels is None:
        budget_padded_voxels = scale_budget(DEFAULT_BUDGET_PADDED_VOXELS)
    nz = int(image_shape[0])
    pz = nz + sum(axis_linear_fft_padding(nz, psf_shape[0]))
    halo_y, halo_x = 2 * int(psf_shape[1]), 2 * int(psf_shape[2])
    for crop in (4096, 3072, 2048, 1536, 1280, 1024, 768, 512, 384, 256):
        ey = crop + halo_y
        ex = crop + halo_x
        py = ey + sum(axis_linear_fft_padding(ey, psf_shape[1]))
        px = ex + sum(axis_linear_fft_padding(ex, psf_shape[2]))
        if pz * py * px <= budget_padded_voxels:
            return crop
    return 256


def chunked_rlgc(
    image: np.ndarray,
    psf: np.ndarray,
    *,
    crop_yx: "int | None" = None,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
) -> np.ndarray:
    """Lateral-tiled RLGC for volumes larger than the memory budget.

    Retained (non-overlapping) YX tiles of at most ``crop_yx`` exactly cover
    the image; each tile is deconvolved with a discarded halo equal to the
    full PSF support per axis and a per-tile seed offset
    (reference `rlgc.py:795-1031`). ``crop_yx=None`` picks the tile size
    statically from the memory budget (:func:`auto_crop_yx`) in place of
    the reference's OOM-retry shrink.
    """
    image = np.asarray(image, dtype=np.float32)
    psf = np.asarray(psf, dtype=np.float32)
    if psf.ndim == 2:
        psf = psf[None]
    nz, ny, nx = image.shape
    if crop_yx is None:
        crop_yx = auto_crop_yx(image.shape, psf.shape)
    if ny <= crop_yx and nx <= crop_yx:
        return rlgc(
            image, psf, seed=seed, safe_mode=safe_mode, limit=limit,
            max_delta=max_delta, max_iters=max_iters,
        )

    halo_y, halo_x = int(psf.shape[1]), int(psf.shape[2])
    out = np.empty_like(image)
    tile_idx = 0
    for y0, y1 in _axis_retained_bounds(ny, crop_yx):
        for x0, x1 in _axis_retained_bounds(nx, crop_yx):
            ys, ye = max(0, y0 - halo_y), min(ny, y1 + halo_y)
            xs, xe = max(0, x0 - halo_x), min(nx, x1 + halo_x)
            tile = image[:, ys:ye, xs:xe]
            dec = rlgc(
                tile, psf, seed=seed + tile_idx, safe_mode=safe_mode,
                limit=limit, max_delta=max_delta, max_iters=max_iters,
            )
            out[:, y0:y1, x0:x1] = dec[:, y0 - ys : y1 - ys, x0 - xs : x1 - xs]
            tile_idx += 1
    return out


def _axis_retained_bounds(length: int, crop: int) -> list[tuple[int, int]]:
    """Non-overlapping retained tile bounds exactly covering [0, length)
    (reference `rlgc.py:479-504`)."""
    if length <= crop:
        return [(0, length)]
    n = int(np.ceil(length / crop))
    edges = np.linspace(0, length, n + 1).round().astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(n)]


# ---------------------------------------------------------------- reference
# name-compatible helpers (`utils/rlgc.py` public surface: kl_div,
# pad_for_linear_fft, next_gpu_fft_size, fft_conv, clear_rlgc_caches)
from .fftutils import fft_conv, next_smooth_fft_size  # noqa: E402,F401

next_gpu_fft_size = next_smooth_fft_size


def kl_div(p, q, mask=None):
    """Masked KL divergence (reference `rlgc.py:389-419`)."""
    p = jnp.asarray(p, jnp.float32)
    q = jnp.asarray(q, jnp.float32)
    if mask is None:
        mask = jnp.ones_like(p)
    return float(_kl_div(p, q, jnp.asarray(mask, jnp.float32)))


def pad_for_linear_fft(image, psf_shape, pad_yx: bool = True):
    """Pad a 3D image for linear FFT convolution; returns (padded,
    pad_width) (reference `rlgc.py:136-176`)."""
    image = jnp.asarray(image)
    pad_width = linear_fft_pad_width(tuple(image.shape), tuple(psf_shape), pad_yx)
    return pad_symmetric(image, pad_width), pad_width


def clear_rlgc_caches(clear_memory_pool: bool = False) -> None:
    """Drop compiled-program and buffer caches (reference
    `rlgc.py:39-72` frees cuFFT plans + CuPy pools; the JAX analog is
    the global trace/compile cache; device buffers are freed when their
    arrays die)."""
    import jax

    jax.clear_caches()
