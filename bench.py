"""Benchmark: MERFISH pipeline stage rates on one NVIDIA GPU.

    python bench.py

Times each stage of the per-tile path on device-resident, production-
shaped volumes (32, 1024, 1024):

- decode: Gaussian lowpass + nearest-codeword decode of a 16-bit slab,
- rlgc: Richardson-Lucy Gradient-Consensus deconvolution to convergence
  with a realistic 3D PSF (single solve, then the paired two-slot queue
  `rlgc_batch` runs in production),
- registration: staged phase-correlation pair registration,
- ufish: U-FISH U-Net inference, batch-8 z planes,
- sofima: deformable-flow estimation on the same pair,
- fusion, e2e_tile, e2e_steady_state: real tiles through the pipeline
  with datastore reads and writes (host I/O included),
- production_case: the 2-tile (16, 1024, 1024) hermetic case through the
  orchestrators, with F1,
- pipeline: the combined per-tile device rate under the reference's
  per-tile work composition (9 fiducial-round decons + 16 readout-bit
  decons + 8 pairwise round registrations + 16 U-FISH predictions + one
  full decode; `DataRegistration._generate_registrations`,
  `_apply_registration_to_bits`, `PixelDecoder.decode_one_tile`).

Prints one JSON line per stage, each naming the device (platform,
device_kind, count); the last line is the pipeline headline. Exits
non-zero without a line when JAX finds no GPU.

Baselines (no voxels/sec is published for the reference — BASELINE.md),
all estimates, labeled in-line:

- decode: ~1e8 voxels/s, an RTX 3090-class kernel estimate for the cuVS
  nearest-codeword path (order of magnitude only).
- rlgc / pipeline: from dataset geometry and published wall-clock
  (`examples/zhuang_lab/00_readme.txt`: register+deconvolve ~1 week,
  decode ~0.5 week, 1x RTX 3090): ~42 tiles x (50 z x 2048^2) with ~25
  deconvolved volumes per tile gives ~3.6e5 decon-vox/s, and the whole
  pipeline ~9.7e3 out-vox/s, end to end including the reference's host
  I/O.
- registration, ufish, sofima and fusion have no reference denominator;
  they report against the whole-pipeline rate, labeled.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REFERENCE_DECODE_VOXELS_PER_SEC = 1.0e8  # RTX 3090-class kernel ESTIMATE

# per-tile work composition (reference call stacks, SURVEY.md §3.1/3.2)
N_DECON_VOLUMES = 9 + 16
N_REGISTRATION_PAIRS = 8
N_PREDICT_VOLUMES = 16  # U-FISH runs once per readout bit

_MOP_TILES = 42
_MOP_TILE_VOXELS = 50 * 2048 * 2048
_WEEK_S = 7 * 24 * 3600.0
REFERENCE_RLGC_VOXELS_PER_SEC = (
    _MOP_TILES * N_DECON_VOLUMES * _MOP_TILE_VOXELS / _WEEK_S
)  # ~3.6e5 decon-vox/s
REFERENCE_PIPELINE_VOXELS_PER_SEC = (
    _MOP_TILES * _MOP_TILE_VOXELS / (1.5 * _WEEK_S)
)  # ~9.7e3 out-vox/s

NZ, NY, NX = 32, 1024, 1024  # production slab
TILE_VOXELS = NZ * NY * NX
PIPELINE_TILE = (16, 512, 512)  # tiles of the e2e stages

DEVICE: dict = {}


def _emit(metric: str, value: float, unit: str, baseline: float, **extra) -> None:
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(value, 1),
                "unit": unit,
                "vs_baseline": round(value / baseline, 3),
                "device": DEVICE,
                **extra,
            },
            default=float,  # numpy scalars in nested detail dicts
        ),
        flush=True,
    )


def _timed(fn, n: int) -> float:
    """Seconds per call of ``fn`` over ``n`` chained calls, after one that
    compiles; the last output is waited for."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        del out
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _gaussian_kernel(sigma_zyx, support_zyx) -> np.ndarray:
    """Peak-1 anisotropic Gaussian on an odd support (float32)."""
    grids = np.meshgrid(
        *[np.arange(s) - (s // 2) for s in support_zyx], indexing="ij"
    )
    return np.exp(
        -sum(g**2 / (2.0 * s**2) for g, s in zip(grids, sigma_zyx))
    ).astype(np.float32)


def _blurred_beads(jax, jnp, key, threshold, height, kernel):
    """Random impulses convolved with ``kernel``, plus a flat background,
    generated on the device."""
    from merfish3d_tpu.ops.fftutils import fft_conv_full, fftn_spec, pad_psf

    impulses = (
        jax.random.uniform(key, (NZ, NY, NX), jnp.float32) > threshold
    ).astype(jnp.float32) * height
    otf = fftn_spec(pad_psf(jnp.asarray(kernel), impulses.shape))
    return fft_conv_full(impulses, otf) + 40.0


def bench_decode(jax, jnp) -> float:
    """Lowpass + decode slab rate (voxels of decoded output per second)."""
    from merfish3d_tpu.ops import decode as dec
    from merfish3d_tpu.ops.filters import gaussian_lowpass

    n_bits, n_words = 16, 120
    rng = np.random.default_rng(0)
    cb = np.zeros((n_words, n_bits), np.float32)
    for i in range(n_words):
        cb[i, rng.choice(n_bits, 4, replace=False)] = 1.0
    codebook_t = jnp.asarray(dec.normalize_codebook(cb).T)
    background = jnp.zeros(n_bits, jnp.float32)
    normalization = jnp.full(n_bits, 50.0, jnp.float32)
    # generated on the device: the bench times the kernels, not the upload
    tile = jax.random.uniform(
        jax.random.PRNGKey(0), (n_bits, NZ, NY, NX), jnp.float32
    ) * 120.0

    @jax.jit
    def step(tile):
        lp = gaussian_lowpass(tile, sigma=(3.0, 1.0, 1.0))
        return dec.decode_planes(
            lp, codebook_t, background, normalization,
            magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176,
        )

    return TILE_VOXELS / _timed(lambda: step(tile), 10)


def bench_rlgc(jax, jnp) -> tuple[float, float, int]:
    """RLGC to convergence: (voxels/s, s/iter, iterations), the faster of
    the single solve and the paired queue `rlgc_batch` runs."""
    from functools import partial

    from merfish3d_tpu.ops.rlgc import (
        _rlgc_core,
        _rlgc_queue_core,
        linear_fft_pad_width,
        pad_symmetric,
        pairing_enabled,
    )

    # a realistic anisotropic 3D PSF and a blurred bead volume
    psf = _gaussian_kernel((1.5, 2.0, 2.0), (9, 15, 15))
    psf = jnp.asarray(psf / psf.sum())
    blurred = _blurred_beads(jax, jnp, jax.random.PRNGKey(1), 0.9995, 2000.0, psf)
    pad_width = linear_fft_pad_width((NZ, NY, NX), psf.shape, pad_yx=True)
    padded = pad_symmetric(jnp.clip(blurred, 0, 65535), pad_width)
    kw = dict(pad_width=pad_width, safe_mode=True, limit=0.01, max_delta=0.001,
              max_iters=20)

    _, iters = _rlgc_core(padded, psf, jax.random.PRNGKey(42), **kw)
    n_iters = max(int(iters), 1)
    elapsed = _timed(lambda: _rlgc_core(padded, psf, jax.random.PRNGKey(42), **kw), 1)
    if pairing_enabled():
        queue = jax.jit(partial(_rlgc_queue_core, **kw))
        stack = jnp.stack([padded, padded * 1.01])
        keys = jnp.stack([jax.random.PRNGKey(42), jax.random.PRNGKey(43)])
        elapsed = min(elapsed, _timed(lambda: queue(stack, psf, keys), 1) / 2.0)
    return TILE_VOXELS / elapsed, elapsed / n_iters, n_iters


def bench_registration(jax, jnp) -> float:
    """Staged pair registration on a device-resident bead pair (voxels/s)."""
    from merfish3d_tpu.ops.registration import (
        _register_rounds_program,
        register_pair_to_fixed,
    )

    fixed = _blurred_beads(
        jax, jnp, jax.random.PRNGKey(2), 0.999, 1500.0,
        _gaussian_kernel((1.2, 1.8, 1.8), (7, 11, 11)),
    )
    moving = jnp.roll(fixed, (1, 6, -9), axis=(0, 1, 2))
    np.asarray(register_pair_to_fixed(fixed, moving, spacing_zyx_um=(0.315, 0.098, 0.098)))
    movings = moving[None]
    return TILE_VOXELS / _timed(
        lambda: _register_rounds_program(fixed, movings, 10, False), 10
    )


def bench_sofima(jax, jnp) -> float:
    """Deformable-flow estimation rate on a device-resident pair (voxels/s
    over the registered volume). The estimator is host-orchestrated (flow
    cleaning runs on the host), so its wall-clock is the measurement."""
    from merfish3d_tpu.ops.flow import (
        SofimaRegistrationConfig,
        estimate_sofima_flow_field_xyz_px,
    )

    fixed = _blurred_beads(
        jax, jnp, jax.random.PRNGKey(5), 0.999, 1500.0,
        _gaussian_kernel((1.0, 1.5, 1.5), (5, 9, 9)),
    )
    moving = jnp.roll(fixed, (3, -2), axis=(1, 2))
    cfg = SofimaRegistrationConfig(residual_iterations=1)
    estimate_sofima_flow_field_xyz_px(fixed, moving, cfg)  # compile
    best = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        estimate_sofima_flow_field_xyz_px(fixed, moving, cfg)
        best = min(best, time.perf_counter() - t0)
    return TILE_VOXELS / best


def bench_ufish(jax, jnp) -> float:
    """U-FISH inference rate (probability voxels/s) on a device-resident
    tile — the c32 U-Net the reference runs per readout bit
    (`DataRegistration.py:886-899`)."""
    from merfish3d_tpu.models.ufish import UFishPredictor

    pred = UFishPredictor()
    vol = jax.random.uniform(jax.random.PRNGKey(9), (NZ, NY, NX), jnp.float32) * 200.0
    return TILE_VOXELS / _timed(lambda: pred.predict_device(vol), 5)


def bench_fusion(workdir: Path) -> tuple[float, dict]:
    """Global stitch + feathered streamed fusion rate (fused out-voxels/s
    including datastore reads and chunk writes) over a 4-tile grid
    (reference `DataRegistration.py:1650-1837`)."""
    from merfish3d_tpu.pipeline.stitching import fuse_global_registered, global_register
    from merfish3d_tpu.utils.simulation import generate_synthetic_experiment

    shape = PIPELINE_TILE
    ds, _gt = generate_synthetic_experiment(
        workdir / "fusion" / "qi2labdatastore", shape=shape, n_spots=200, seed=5,
        n_tiles=4, tile_offset_px=(0.0, 0.0, shape[2] * 0.75),
    )
    # pass 1 compiles the pairwise-registration programs; pass 2 is timed
    t0 = time.perf_counter()
    global_register(ds, verbose=0)
    cold_reg = time.perf_counter() - t0
    t0 = time.perf_counter()
    global_register(ds, verbose=0)
    t_reg = time.perf_counter() - t0
    t0 = time.perf_counter()
    fuse_global_registered(ds, verbose=0)
    t_fuse = time.perf_counter() - t0
    fused, _geom = ds.load_global_fiducial_image()
    return int(np.prod(np.asarray(fused).shape)) / (t_reg + t_fuse), {
        "fused_shape": [int(v) for v in fused.shape],
        "global_register_seconds": round(t_reg, 2),
        "global_register_compile_overhead_seconds": round(cold_reg - t_reg, 2),
        "fuse_seconds": round(t_fuse, 2),
    }


def _registration(ds, cache, **kw):
    from merfish3d_tpu.pipeline.registration import DataRegistration

    return DataRegistration(
        ds, decon_fiducial=False, decon_readout=True, decon_max_iters=10,
        overwrite=True, verbose=0, device_cache=cache, persist="minimal",
        save_all_fiducial_registered=False, ufish_model="dog", **kw,
    )


def bench_e2e_tile(workdir: Path) -> tuple[float, dict]:
    """One tile end to end: datastore reads → decon → registration →
    prediction → decode → extraction → parquet, host I/O included.
    Pass 1 compiles; pass 2 is the per-tile rate a run sustains."""
    from merfish3d_tpu.pipeline import PixelDecoder
    from merfish3d_tpu.pipeline.handoff import TileDeviceCache
    from merfish3d_tpu.utils import profiling
    from merfish3d_tpu.utils.simulation import generate_synthetic_experiment

    ds, _gt = generate_synthetic_experiment(
        workdir / "e2e" / "qi2labdatastore", shape=PIPELINE_TILE, n_spots=300, seed=3
    )

    def one_pass():
        profiling.reset()
        profiling.enable(True)
        cache = TileDeviceCache()
        t0 = time.perf_counter()
        reg = _registration(ds, cache, global_registration=True)
        reg.register_all_tiles()
        t_reg = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoder = PixelDecoder(
            ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
            device_cache=cache,
        )
        decoder._load_global_normalization_vectors(recalculate=True)
        decoder.decode_one_tile(0, save=True)
        t_dec = time.perf_counter() - t0
        t0 = time.perf_counter()
        reg.drain_persistence()
        t_drain = time.perf_counter() - t0
        profiling.enable(False)
        return t_reg, t_dec, t_drain, profiling.snapshot()

    cold = one_pass()
    t_reg, t_dec, t_drain, prof = one_pass()
    out_voxels = int(np.prod(PIPELINE_TILE))
    total = t_reg + t_dec + t_drain
    return out_voxels / total, {
        "tile_shape": list(PIPELINE_TILE),
        "register_seconds": round(t_reg, 2),
        "decode_seconds": round(t_dec, 2),
        "persist_drain_seconds": round(t_drain, 2),
        # decoded features ready; intermediate image writes still draining
        "results_ready_voxels_per_sec": round(out_voxels / (t_reg + t_dec), 1),
        "first_tile_compile_overhead_seconds": round(sum(cold[:3]) - total, 2),
        "boundary_seconds": prof["seconds"],
        "boundary_mbps": prof["mbps"],
    }


def bench_e2e_steady_state(workdir: Path) -> tuple[float, dict]:
    """Marginal per-tile rate of the streaming loop over 3 tiles (register
    tile → decode tile, persistence draining under the next tile's
    compute): voxels of tiles 2..3 over the wall between tile-1 and tile-3
    decode completion; the final drain is timed apart."""
    from merfish3d_tpu.pipeline import PixelDecoder
    from merfish3d_tpu.pipeline.handoff import TileDeviceCache
    from merfish3d_tpu.utils.simulation import generate_synthetic_experiment

    shape, n_tiles = PIPELINE_TILE, 3
    ds, _gt = generate_synthetic_experiment(
        workdir / "steady" / "qi2labdatastore", shape=shape, n_spots=300 * n_tiles,
        seed=7, n_tiles=n_tiles, tile_offset_px=(0.0, 0.0, shape[2] * 0.8),
    )
    cache = TileDeviceCache(max_tiles=2)
    reg = _registration(ds, cache, global_registration=False)
    decoder = PixelDecoder(
        ds, minimum_pixels=4, magnitude_threshold=(0.9, 10.0), verbose=0,
        device_cache=cache,
    )
    decoder._global_normalization_vector = np.full(16, 400.0, np.float32)
    decoder._global_background_vector = np.full(16, 40.0, np.float32)
    marks = []
    t_start = time.perf_counter()
    for t in range(n_tiles):
        reg.register_one_tile(t)
        decoder.decode_one_tile(t, save=True)
        cache.evict(t)
        marks.append(time.perf_counter())
    t0 = time.perf_counter()
    reg.drain_persistence()
    t_drain = time.perf_counter() - t0
    tile_voxels = int(np.prod(shape))
    steady = (marks[-1] - marks[0]) / (n_tiles - 1)
    sustained = (marks[-1] - marks[0] + t_drain) / (n_tiles - 1)
    return tile_voxels / steady, {
        "tile_shape": list(shape),
        "n_tiles": n_tiles,
        "tile_seconds": [
            round(m - (marks[i - 1] if i else t_start), 2) for i, m in enumerate(marks)
        ],
        "steady_tile_seconds": round(steady, 2),
        "final_drain_seconds": round(t_drain, 2),
        "sustained_voxels_per_sec": round(tile_voxels / sustained, 1),
    }


def bench_production_case(workdir: Path) -> tuple[float, dict]:
    """The hermetic production case: 2 overlapping (16, 1024, 1024) tiles,
    16-bit MHD4 codebook with blank codewords, chromatic injection,
    deformable registration, RLGC decon, DoG spot prediction, blank-
    fraction filter and dedup — rate + F1 through the orchestrators."""
    from merfish3d_tpu.utils.production_case import run_production_case

    r = run_production_case(
        workdir / "production", n_genes=80, n_blanks=10, decon=True,
        decon_max_iters=10, deformable=True, chromatic=True, num_iterations=4,
        seed=21, shape=(16, 1024, 1024), n_spots=2400, ufish_model="dog",
    )
    return float(r.pop("pipeline_voxels_per_sec")), r


def main() -> int:
    import jax

    from merfish3d_tpu import device
    from merfish3d_tpu.utils.jaxcache import enable_persistent_cache

    DEVICE.update(device.describe())
    if DEVICE["platform"] != "gpu":
        print(f"bench: no GPU ({DEVICE['platform']} backend)", file=sys.stderr)
        return 1

    enable_persistent_cache()
    import jax.numpy as jnp

    # Stages after the headline check the remaining wall-clock budget and
    # emit an explicit skipped record instead of overrunning it.
    t_start = time.monotonic()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1800"))

    def skip_stage(metric: str, need_s: float) -> bool:
        left = budget_s - (time.monotonic() - t_start)
        if left >= need_s:
            return False
        _emit(metric, 0.0, "voxel/s", REFERENCE_PIPELINE_VOXELS_PER_SEC,
              baseline_kind="skipped_insufficient_budget", skipped=True,
              budget_seconds_left=round(left, 1), estimated_need_seconds=need_s)
        return True

    whole = "vs_whole_reference_pipeline_rate"
    with_io = "mop_wallclock_derived_incl_host_io"
    decode_vps = bench_decode(jax, jnp)
    _emit("decode_voxels_per_sec", decode_vps, "voxel/s",
          REFERENCE_DECODE_VOXELS_PER_SEC, baseline_kind="rtx3090_kernel_estimate")
    rlgc_vps, rlgc_s_per_iter, rlgc_iters = bench_rlgc(jax, jnp)
    _emit("rlgc_voxels_per_sec", rlgc_vps, "voxel/s", REFERENCE_RLGC_VOXELS_PER_SEC,
          baseline_kind="mop_wallclock_derived",
          seconds_per_iteration=round(rlgc_s_per_iter, 4), iterations=rlgc_iters)
    reg_vps = bench_registration(jax, jnp)
    _emit("registration_voxels_per_sec", reg_vps, "voxel/s",
          REFERENCE_PIPELINE_VOXELS_PER_SEC, baseline_kind=whole)
    ufish_vps = bench_ufish(jax, jnp)
    _emit("ufish_voxels_per_sec", ufish_vps, "voxel/s",
          REFERENCE_PIPELINE_VOXELS_PER_SEC, baseline_kind=whole)

    extra = {}
    workdir = Path(tempfile.mkdtemp(prefix="merfish_bench_"))
    try:
        if not skip_stage("sofima_voxels_per_sec", 90.0):
            v = bench_sofima(jax, jnp)
            extra["sofima_voxels_per_sec"] = round(v, 1)
            _emit("sofima_voxels_per_sec", v, "voxel/s",
                  REFERENCE_PIPELINE_VOXELS_PER_SEC, baseline_kind=whole)
        for metric, fn, need, kind in (
            ("fusion_voxels_per_sec", bench_fusion, 90.0, whole),
            ("e2e_tile_voxels_per_sec", bench_e2e_tile, 240.0, with_io),
            ("e2e_steady_state_voxels_per_sec", bench_e2e_steady_state, 180.0, with_io),
            ("production_case_voxels_per_sec", bench_production_case, 900.0, with_io),
        ):
            if skip_stage(metric, need):
                continue
            v, detail = fn(workdir)
            extra[metric] = round(v, 1)
            if "f1" in detail:
                extra["production_case_f1"] = detail["f1"]
            _emit(metric, v, "voxel/s", REFERENCE_PIPELINE_VOXELS_PER_SEC,
                  baseline_kind=kind, **detail)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    seconds_per_tile = (
        N_DECON_VOLUMES * TILE_VOXELS / rlgc_vps
        + N_REGISTRATION_PAIRS * TILE_VOXELS / reg_vps
        + N_PREDICT_VOLUMES * TILE_VOXELS / ufish_vps
        + TILE_VOXELS / decode_vps
    )
    _emit(
        "pipeline_voxels_per_sec", TILE_VOXELS / seconds_per_tile, "voxel/s",
        REFERENCE_PIPELINE_VOXELS_PER_SEC, baseline_kind="mop_wallclock_derived",
        composition=(
            f"{N_DECON_VOLUMES}x rlgc + {N_REGISTRATION_PAIRS}x register + "
            f"{N_PREDICT_VOLUMES}x ufish + 1x decode per tile"
        ),
        decode_voxels_per_sec=round(decode_vps, 1),
        rlgc_voxels_per_sec=round(rlgc_vps, 1),
        registration_voxels_per_sec=round(reg_vps, 1),
        ufish_voxels_per_sec=round(ufish_vps, 1),
        **extra,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
