#!/usr/bin/env python3
"""Prove the MERFISH pipeline runs on an NVIDIA GPU.

    python chip_smoke.py             # one card: phases 0-2
    python chip_smoke.py --cards 4   # only the multi-card path, against one card

Phase 0 prints the machine: card, JAX, the optional packages, the compile
cache and the native host ops. Phase 1 runs each device program of the
main path at real in-plane width (2048²) and compares it with a plain
reference: a float32 CPU run of the same function, a float64 numpy/scipy
oracle, or a known ground truth. Phase 2 drives the production case
(raw tiles → datastore → registration → decode → F1) through the normal
orchestrators. Every check prints its error beside its tolerance; any
failed check or phase ends the run with a non-zero exit and no result.

The last line of standard output is one JSON object naming the device.
The script exits non-zero without it when JAX finds no GPU. It runs in
one process and drives every visible card from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OPTIONAL_PACKAGES = (
    "pandas", "pyarrow", "tensorstore", "flax", "sklearn", "PIL",
    "matplotlib", "contourpy",
)
# the pinned small production case (tests/test_production_geometry.py)
PINNED_CASE = dict(
    shape=(6, 192, 192), n_spots=250, n_genes=40, n_blanks=6, decon=False,
    deformable=True, chromatic=True, num_iterations=1, minimum_pixels=4,
    seed=21,
)
PINNED_F1, PINNED_F1_TOL = 0.8921, 0.02
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def log(*parts) -> None:
    print(*parts, flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of the phase-1 checks. ``REAL`` is what the card runs;
    the CPU reference runs each check's ``*_ref`` cut of it."""

    yx: int = 2048
    rlgc_z: int = 50          # the timed full tile
    rlgc_ref_z: int = 4       # z cut for the CPU comparison
    rlgc_ref_iters: int = 2
    rlgc_time_iters: int = 6
    psf: tuple = (31, 31, 31)
    pc_z: int = 16
    flow_z: int = 12
    flow_period: float = 512.0  # px, of the known deformation
    ufish_planes: int = 4
    decode_bits: int = 16
    decode_z: int = 50        # the timed full tile
    decode_ref_z: int = 6     # z cut for the scipy/float64 oracle


REAL = Sizes()


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its
    monitoring events, so phase times can report compile time apart."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._listen)

    def _listen(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.total += float(duration)


class Checks:
    """Collects comparisons; :meth:`finish` raises if any failed."""

    def __init__(self, phase: str):
        self.phase, self.failed = phase, []

    def check(self, name: str, err: float, tol: float, detail: str = "") -> None:
        ok = bool(np.isfinite(err) and err <= tol)
        log(f"[{self.phase}] {name}: err={err:.3e} tol={tol:.1e} {detail} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def finish(self) -> None:
        if self.failed:
            raise AssertionError(f"{self.phase} failed: {', '.join(self.failed)}")


def _timed(fn, *args, repeat: int = 3, **kw):
    """(result, best seconds) over ``repeat`` warm runs, after one run
    that compiles."""
    import jax

    out = jax.block_until_ready(fn(*args, **kw))
    best = np.inf
    for _ in range(repeat):
        del out  # one result live at a time: full tiles fill the card
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return out, best


def _bound_line(name: str, seconds: float, nbytes: float) -> str:
    bound = nbytes / HBM_BYTES_PER_S
    return (f"[phase1] {name}: {seconds * 1e3:.3f} ms; bytes bound "
            f"{bound * 1e3:.3f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s); "
            f"{seconds / bound:.2f}x the bound")


def _blobs(shape, n, seed, sigma=(1.0, 1.5, 1.5), scale=1000.0):
    """Smooth random spots on a flat background, float32 (host)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    vol[tuple(rng.integers(0, s, n) for s in shape)] = rng.uniform(0.5, 2.0, n) * scale
    return ndi.gaussian_filter(vol, sigma) + np.float32(10.0)


# ------------------------------------------------------------------ phase 0
def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def phase0() -> str:
    import jax

    from merfish3d_tpu import device, native
    from merfish3d_tpu.utils.jaxcache import enable_persistent_cache

    smi = nvidia_smi()
    log(f"[phase0] card: {smi}")
    log(f"[phase0] python {sys.version.split()[0]} jax {jax.__version__} "
        f"devices {jax.devices()}")
    log(f"[phase0] device {device.describe()} bytes_limit {device.bytes_limit()}")
    for name in OPTIONAL_PACKAGES:
        found = importlib.util.find_spec(name) is not None
        log(f"[phase0] package {name}: {'present' if found else 'absent'}")
    log(f"[phase0] g++: {shutil.which('g++')}")
    log(f"[phase0] compile cache: {enable_persistent_cache()}")
    log(f"[phase0] native host ops loaded: {native.available()}")
    return smi


# ------------------------------------------------------------------ phase 1
def check_rlgc(sizes: Sizes, checks: Checks, ref_device, timing: bool = True) -> None:
    """RLGC: the card against a float32 CPU run of the same solve (z cut),
    then the full tile timed per iteration with its memory analysis."""
    import jax
    import jax.numpy as jnp

    from merfish3d_tpu.models.psf import gaussian_psf
    from merfish3d_tpu.ops.fftutils import (
        fft_conv_full,
        fftn_spec,
        linear_fft_pad_width,
        pad_psf,
        pad_symmetric,
    )
    from merfish3d_tpu.ops.rlgc import _rlgc_core

    psf = gaussian_psf(emission_wavelength_um=0.52, na=1.35, ri=1.51,
                       voxel_size_zyx_um=(0.315, 0.098, 0.098), shape_zyx=sizes.psf)
    rng = np.random.default_rng(0)

    def solve(image, iters, device=None, kernel=psf):
        pad = linear_fft_pad_width(image.shape, psf.shape)
        with jax.default_device(device or jax.devices()[0]):
            padded = pad_symmetric(jnp.asarray(image), pad)
            recon, n = _rlgc_core(padded, jnp.asarray(kernel), jax.random.PRNGKey(3),
                                  pad_width=pad, max_iters=iters, limit=0.0,
                                  max_delta=0.0)
            return np.asarray(recon), int(n), pad

    cut = rng.poisson(_blobs((sizes.rlgc_ref_z, sizes.yx, sizes.yx), 800, 1))
    cut = cut.astype(np.float32)

    # the continuous part first: one FFT convolution at the padded cut
    pad = linear_fft_pad_width(cut.shape, psf.shape)
    conv = jax.jit(lambda x, k: fft_conv_full(x, fftn_spec(pad_psf(k, x.shape))))
    padded_cut = np.pad(cut, pad, mode="symmetric")
    got = np.asarray(conv(padded_cut, psf))
    with jax.default_device(ref_device):
        want = np.asarray(conv(padded_cut, psf))
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    checks.check(f"fft_conv_full {padded_cut.shape} vs CPU float32", err, 1e-5,
                 "(max abs err / max; cuFFT vs the CPU's FFT)")

    t0 = time.perf_counter()
    ref, n_ref, _ = solve(cut, sizes.rlgc_ref_iters, ref_device)
    t_ref = time.perf_counter() - t0
    got, n_got, _ = solve(cut, sizes.rlgc_ref_iters)
    # The update is gated on the sign of the consensus convolution, so a
    # voxel whose consensus lies within float32 rounding of 0 may take the
    # other branch under any change of rounding, and then differs by up to
    # its whole value. The card is held to the rounding sensitivity of the
    # solve itself, measured here on the card: the same solve with every
    # other PSF voxel moved up by one ulp. (On the CPU at this size such a
    # nudge moves the solve by a relative L2 of 1.0e-3 with 4e-5 of the
    # voxels flipped; the card differs from the CPU by 1.8e-3 and 1.3e-4.)
    checker = np.indices(psf.shape).sum(0) % 2 == 0
    nudged_psf = np.where(checker, np.nextafter(psf, np.float32(np.inf)), psf)
    nudged, _, _ = solve(cut, sizes.rlgc_ref_iters, kernel=nudged_psf)

    def spread(a, b):
        diff, scale = np.abs(a - b), np.max(np.abs(b))
        return (float(np.linalg.norm(diff) / np.linalg.norm(b)),
                float(np.mean(diff > 1e-3 * scale)), float(diff.max() / scale))

    (l2, share, mx), (l2_self, share_self, mx_self) = spread(got, ref), spread(nudged, got)
    label = (f"rlgc {cut.shape} x{sizes.rlgc_ref_iters} iters vs CPU float32 "
             f"(z cut from {sizes.rlgc_z}; CPU {t_ref:.1f} s)")
    checks.check(f"{label} relative L2", l2, 5 * l2_self + 1e-6,
                 f"(tol 5x the card's own under a 1-ulp PSF change, {l2_self:.3e}; "
                 f"max abs err / max {mx:.3e} vs {mx_self:.3e})")
    checks.check(f"{label} share of voxels off by > 1e-3 of max", share,
                 5 * share_self + 1e-6,
                 f"(consensus-gate flips; the card's own {share_self:.3e})")
    if n_ref != n_got:
        checks.check("rlgc iteration count equal", abs(n_ref - n_got), 0)
    if not timing:
        return

    tile = rng.poisson(_blobs((sizes.rlgc_z, sizes.yx, sizes.yx), 8000, 2))
    tile = tile.astype(np.float32)
    pad = linear_fft_pad_width(tile.shape, psf.shape)
    padded = pad_symmetric(jnp.asarray(tile), pad)
    del tile
    kw = dict(pad_width=pad, limit=0.0, max_delta=0.0)
    args = (padded, jnp.asarray(psf), jax.random.PRNGKey(3))
    compiled = _rlgc_core.lower(*args, max_iters=sizes.rlgc_time_iters, **kw).compile()
    log(f"[phase1] rlgc padded {tuple(padded.shape)} memory_analysis: "
        f"{compiled.memory_analysis()}")
    hlo = compiled.as_text()
    log(f"[phase1] rlgc compiled program: {hlo.count(' fusion(')} fusions, "
        f"{hlo.count(' fft(')} FFTs")
    runs = {}
    for iters in (1, sizes.rlgc_time_iters):
        (recon, n), secs = _timed(_rlgc_core, *args, max_iters=iters, repeat=2, **kw)
        runs[iters] = (int(n), secs)
        if not np.all(np.isfinite(np.asarray(recon[:, ::64, ::64]))):
            checks.check(f"rlgc {iters} iters finite", np.inf, 0)
    (n1, t1), (n6, t6) = runs[1], runs[sizes.rlgc_time_iters]
    per_iter = (t6 - t1) / max(n6 - n1, 1)
    voxels = float(np.prod(padded.shape))
    # an iteration's least traffic: six complex 3-D transforms (read +
    # write 8-byte complex each) plus the elementwise chain (observed,
    # recon, prev, norm in; recon, prev out; three OTF pairs in)
    log(f"[phase1] rlgc tile ({sizes.rlgc_z}, {sizes.yx}, {sizes.yx}): "
        f"{n6} iters {t6:.3f} s, 1 iter {t1:.3f} s")
    log(_bound_line("rlgc iteration", per_iter, voxels * (6 * 16 + 6 * 4 + 3 * 8)))
    fft = jax.jit(lambda x: jnp.fft.ifftn(jnp.fft.fftn(x)))
    _, t_fft = _timed(fft, padded.astype(jnp.complex64))
    log(_bound_line("fftn+ifftn complex64 (cuFFT)", t_fft, voxels * 2 * 16))


def check_phase_corr(sizes: Sizes, checks: Checks) -> None:
    """Sub-pixel phase correlation against a known Fourier shift."""
    import scipy.fft

    from merfish3d_tpu.ops.phase_corr import phase_cross_correlation

    fixed = _blobs((sizes.pc_z, sizes.yx, sizes.yx), 3000, 3)
    truth = np.array([0.4, -2.7, 3.3])
    spec = scipy.fft.rfftn(fixed.astype(np.float64), workers=-1)
    freqs = np.meshgrid(
        *[np.fft.fftfreq(n) for n in fixed.shape[:-1]],
        np.fft.rfftfreq(fixed.shape[-1]), indexing="ij", sparse=True,
    )
    ramp = np.exp(-2j * np.pi * sum(f * s for f, s in zip(freqs, truth)))
    moving = scipy.fft.irfftn(spec * ramp, fixed.shape, workers=-1).astype(np.float32)
    del spec, ramp
    est = np.asarray(phase_cross_correlation(fixed, moving, upsample_factor=10))
    # the push shift that aligns moving onto fixed undoes the applied
    # shift; the Fourier shift is circular, so wrap aliases are equal
    n = np.asarray(fixed.shape)
    err = float(np.max(np.abs((est + truth + n / 2) % n - n / 2)))
    checks.check(f"phase correlation {fixed.shape} shift {truth.tolist()}", err,
                 0.1 + 1e-6, f"(estimate {np.round(est, 3).tolist()}, upsample 10)")


def check_flow_warp(sizes: Sizes, checks: Checks, ref_device) -> None:
    """Flow against a known smooth deformation; the flow warp against a
    float32 CPU run of the same warp."""
    import jax
    import scipy.ndimage as ndi

    from merfish3d_tpu.ops.flow import estimate_sofima_flow_field_xyz_px
    from merfish3d_tpu.ops.warp import warp_affine_plus_flow

    shape = (sizes.flow_z, sizes.yx, sizes.yx)
    ref = _blobs(shape, 20000, 4)
    period = sizes.flow_period

    def truth(y, x):
        return 1.5 * np.sin(2 * np.pi * y / period), 1.0 * np.cos(2 * np.pi * x / period)

    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij", sparse=True)
    dx, dy = truth(yy, xx)
    moving = ndi.map_coordinates(
        ref, np.broadcast_arrays(zz, yy + dy, xx + dx), order=1, mode="nearest"
    ).astype(np.float32)
    del zz, yy, xx, dx, dy
    flow, meta = estimate_sofima_flow_field_xyz_px(ref, moving)
    stride, start = meta["map_stride_zyx_px"], meta["map_box_start_xyz_px"]
    ly = start[1] + np.arange(flow.shape[2]) * stride[1]
    lx = start[0] + np.arange(flow.shape[3]) * stride[2]
    tx, ty = truth(ly[:, None], lx[None, :])
    # moving(p) = ref(p + d(p)), so the flow that maps it back is -d
    err = np.concatenate([np.abs(flow[0] + tx).ravel(), np.abs(flow[1] + ty).ravel()])
    checks.check(f"flow {shape} vs known field (median)", float(np.median(err)), 0.25,
                 f"(lattice {flow.shape[1:]}, px)")
    checks.check(f"flow {shape} vs known field (95th pct)",
                 float(np.percentile(err, 95)), 0.75, "(px)")

    kw = dict(transform_zyx_um=np.eye(4), spacing_zyx_um=(0.315, 0.098, 0.098),
              reference_shape=shape, map_stride_zyx_px=stride,
              map_box_start_xyz_px=start)
    got = np.asarray(warp_affine_plus_flow(moving, flow, **kw))
    with jax.default_device(ref_device):
        want = np.asarray(warp_affine_plus_flow(moving, flow, **kw))
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    checks.check(f"warp_affine_plus_flow {shape} vs CPU float32", err, 1e-4,
                 "(max abs err / max)")
    m = sizes.yx // 32
    inner = (slice(1, -1), slice(m, -m), slice(m, -m))

    def ncc(a, b):
        a, b = a[inner] - a[inner].mean(), b[inner] - b[inner].mean()
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    before, after = ncc(ref, moving), ncc(ref, got)
    checks.check("flow warp restores the reference (1 - NCC)", 1.0 - after,
                 min(0.05, 1.0 - before), f"(NCC unwarped {before:.4f}, warped {after:.4f})")


def check_ufish(sizes: Sizes, checks: Checks, ref_device, timing: bool = True) -> None:
    """U-FISH (checked-in synthetic checkpoint): bf16 on the card against
    float32 on the CPU."""
    import pickle

    import jax

    from merfish3d_tpu.models.ufish import UFishPredictor

    with open(REPO / "tests" / "data" / "ufish_synthetic_c8.pkl", "rb") as fh:
        params = pickle.load(fh)
    planes = np.random.default_rng(5).poisson(
        _blobs((sizes.ufish_planes, sizes.yx, sizes.yx), 4000, 5, sigma=(0, 1.5, 1.5))
    ).astype(np.float32)
    got = UFishPredictor(params=params).predict(planes)
    with jax.default_device(ref_device):
        import jax.numpy as jnp

        want = UFishPredictor(params=params, compute_dtype=jnp.float32).predict(planes)
    err = float(np.max(np.abs(got - want)))
    checks.check(f"U-FISH c8 {planes.shape} bf16 vs CPU float32", err, 2e-2,
                 "(max abs probability error; bf16 convs, float32 accumulation)")
    if not timing:
        return
    pred = UFishPredictor(params=params)
    dev_planes = jax.device_put(planes)
    _, secs = _timed(pred.predict_device, dev_planes)
    h = w = sizes.yx
    f = [8, 16, 32]
    # bf16 activations read and written once per conv layer
    convs = [(1, f[0], 1), (f[0], f[0], 1), (f[0], f[1], 4), (f[1], f[1], 4),
             (f[1], f[2], 16), (f[2], f[2], 16), (f[2], f[1], 4), (2 * f[1], f[1], 4),
             (f[1], f[1], 4), (f[1], f[0], 1), (2 * f[0], f[0], 1), (f[0], f[0], 1),
             (f[0], 1, 1)]
    nbytes = sum((ci + co) * h * w / div * 2 for ci, co, div in convs) * len(planes)
    log(_bound_line(f"U-FISH c8 {planes.shape} (cuDNN convs)", secs, nbytes))


def check_lowpass_decode(sizes: Sizes, checks: Checks, timing: bool = True) -> None:
    """Lowpass + decode at 16 bits against scipy's gaussian_filter and a
    float64 nearest codeword, then the full tile timed."""
    import jax
    import jax.numpy as jnp
    import scipy.ndimage as ndi

    from merfish3d_tpu.ops import decode as dec
    from merfish3d_tpu.ops.filters import gaussian_lowpass
    from merfish3d_tpu.utils.simulation import make_mhd4_codebook

    bits = sizes.decode_bits
    book = make_mhd4_codebook(n_genes=20, n_blanks=4, n_bits=bits, seed=0)
    cb = book[[f"bit{b + 1:02d}" for b in range(bits)]].to_numpy(np.float32)
    rng = np.random.default_rng(6)
    shape = (bits, sizes.decode_ref_z, sizes.yx, sizes.yx)
    vol = rng.gamma(2.0, 20.0, shape).astype(np.float32)
    for _ in range(4000):
        z, y, x = (rng.integers(0, n) for n in shape[1:])
        vol[:, z, y, x] += cb[rng.integers(0, len(cb))] * rng.uniform(300, 900)
    sigma = (3.0, 1.0, 1.0)
    bg = np.full(bits, 20.0, np.float32)
    norm = np.full(bits, 60.0, np.float32)
    thr, _ = dec.caller_thresholds(4)
    mag_thr = (0.3, 10.0)

    lp = gaussian_lowpass(jnp.asarray(vol), sigma=sigma)
    decoded, *_ = dec.decode_volume(lp, cb, bg, norm, magnitude_threshold=mag_thr,
                                    distance_threshold=thr, return_scaled=False)
    lp_ref = np.stack([ndi.gaussian_filter(v.astype(np.float64), sigma, mode="reflect")
                       for v in vol])
    err = float(np.max(np.abs(np.asarray(lp) - lp_ref)) / np.max(lp_ref))
    checks.check(f"gaussian lowpass {shape} vs scipy float64", err, 1e-5,
                 "(max abs err / max)")
    cbn = cb / np.linalg.norm(cb, axis=1, keepdims=True)
    mismatched = decided = assigned = 0
    for z in range(shape[1]):
        t = lp_ref[:, z].reshape(bits, -1)
        scaled = np.clip((t - bg[:, None]) / norm[:, None], 0, 1)
        mag = np.sqrt((scaled**2).sum(0))
        sims = cbn.astype(np.float64) @ (scaled / np.maximum(mag, 1e-12))
        top = np.sort(sims, axis=0)
        dist = np.sqrt(np.maximum(2 - 2 * top[-1], 0))
        ok = (dist <= thr) & (mag >= mag_thr[0]) & (mag <= mag_thr[1])
        labels = np.where(ok, sims.argmax(0), -1)
        sure = (top[-1] - top[-2]) > 1e-5
        mismatched += int(np.sum(decoded[z].ravel()[sure] != labels[sure]))
        decided += int(sure.sum())
        assigned += int((labels >= 0).sum())
    checks.check(f"lowpass+decode {shape} labels vs float64 nearest codeword",
                 mismatched, 0, f"(decided voxels {decided}, assigned {assigned}, "
                 "top-2 gap > 1e-5)")
    del vol, lp, lp_ref
    if not timing:
        return

    full = (bits, sizes.decode_z, sizes.yx, sizes.yx)
    live = sum(a.nbytes for a in jax.live_arrays())
    log(f"[phase1] device arrays live before the full decode tile: {live / 1e9:.3f} GB")
    stack = jax.random.uniform(jax.random.PRNGKey(7), full, jnp.float32, 0.0, 80.0)
    voxels = float(np.prod(full[1:]))
    lowpass = jax.jit(lambda v: gaussian_lowpass(v, sigma=sigma))
    lp_dev, t_lp = _timed(lowpass, stack, repeat=2)
    log(_bound_line(f"gaussian lowpass {full}", t_lp, voxels * bits * 8))
    cb_t = jnp.asarray(dec.normalize_codebook(cb).T)
    zc = 8

    def planes(v):
        return [dec.decode_planes(v[:, z0:z0 + zc], cb_t, jnp.asarray(bg),
                                  jnp.asarray(norm), magnitude_threshold=mag_thr,
                                  distance_threshold=thr)
                for z0 in range(0, full[1] - zc + 1, zc)]

    _, t_dec = _timed(planes, lp_dev, repeat=2)
    done = (full[1] // zc) * zc / full[1]
    # bits in (float32); decoded int16, magnitude, distance and bits
    # scaled traces out (float16)
    log(_bound_line(f"decode_planes {full} on device", t_dec / done,
                    voxels * (bits * 4 + 6 + bits * 2)))
    for scaled in (False, True):
        t0 = time.perf_counter()
        dec.decode_volume(lp_dev, cb, bg, norm, magnitude_threshold=mag_thr,
                          distance_threshold=thr, return_scaled=scaled)
        log(f"[phase1] decode_volume {full} return_scaled={scaled} (device + "
            f"readback to host): {time.perf_counter() - t0:.3f} s")


def phase1(sizes: Sizes = REAL) -> None:
    import jax

    cpu = jax.devices("cpu")[0]
    checks = Checks("phase1")
    for name, fn in (
        ("rlgc", lambda: check_rlgc(sizes, checks, cpu)),
        ("phase_corr", lambda: check_phase_corr(sizes, checks)),
        ("flow_warp", lambda: check_flow_warp(sizes, checks, cpu)),
        ("ufish", lambda: check_ufish(sizes, checks, cpu)),
        ("lowpass_decode", lambda: check_lowpass_decode(sizes, checks)),
    ):
        t0 = time.perf_counter()
        fn()
        log(f"[phase1] {name} done in {time.perf_counter() - t0:.1f} s")
    checks.finish()


# ------------------------------------------------------------------ phase 2
def run_case(label: str, clock: CompileClock, **kw) -> dict:
    from merfish3d_tpu.utils.production_case import run_production_case

    c0, t0 = clock.total, time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="merfish_case_") as tmp:
        r = run_production_case(Path(tmp), **kw)
    wall, comp = time.perf_counter() - t0, clock.total - c0
    log(f"[{label}] tiles {r['n_tiles']} x {tuple(r['tile_shape'])}: "
        f"F1 {r['f1']:.4f} precision {r['precision']:.4f} recall {r['recall']:.4f} "
        f"({r['n_decoded_after_filter']} features after filter)")
    log(f"[{label}] seconds: generate {r['generate_seconds']} convert "
        f"{r['convert_seconds']} register {r['register_seconds']} decode "
        f"{r['decode_seconds']}; total {wall:.1f}; compile {comp:.1f} "
        "(summed over compiling threads)")
    return r


def phase2(clock: CompileClock) -> None:
    checks = Checks("phase2")
    run_case("phase2 production", clock)
    r = run_case("phase2 pinned", clock, **PINNED_CASE)
    checks.check(f"pinned case F1 vs {PINNED_F1}", abs(r["f1"] - PINNED_F1),
                 PINNED_F1_TOL, f"(F1 {r['f1']:.4f})")
    checks.finish()


def multi_card(clock: CompileClock, cards: int, **case) -> None:
    """The production case with one tile per card, fanned out over
    ``cards`` cards, against the same case on one card. ``case`` overrides
    `run_production_case` arguments (the CPU test runs a toy size)."""
    import jax

    if len(jax.devices()) < cards:
        raise RuntimeError(f"--cards {cards} needs {cards} devices, "
                           f"{len(jax.devices())} visible")
    checks = Checks("cards")
    case = {"shape": (16, 512, 512), "n_spots": 300 * cards, **case,
            "n_tiles": cards}
    multi = run_case(f"cards {cards}", clock, num_devices=cards, **case)
    single = run_case("cards 1", clock, num_devices=1, **case)
    for t in range(cards):
        a = multi["features_per_tile"].get(t, 0)
        b = single["features_per_tile"].get(t, 0)
        checks.check(f"tile {t} feature count {cards} cards vs 1", abs(a - b), 0,
                     f"({a} vs {b})")
    checks.check(f"F1 {cards} cards vs 1", abs(multi["f1"] - single["f1"]), 0.005,
                 f"({multi['f1']:.4f} vs {single['f1']:.4f})")
    checks.finish()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1,
                   help="run only the multi-card path over this many cards")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU ({dev.platform} backend); nothing to prove",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    clock = CompileClock()
    t0 = time.perf_counter()
    smi = phase0()
    if args.cards > 1:
        phases = [("cards", lambda: multi_card(clock, args.cards))]
    else:
        phases = [("phase1", phase1), ("phase2", lambda: phase2(clock))]
    failed = []
    for name, run in phases:  # a failed phase does not stop the next one
        try:
            run()
        except Exception:
            traceback.print_exc()
            failed.append(name)
    log(f"[done] {time.perf_counter() - t0:.1f} s; compile {clock.total:.1f} s "
        "(summed over compiling threads)")
    if failed:
        print(f"chip_smoke: failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    log(f"card: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
