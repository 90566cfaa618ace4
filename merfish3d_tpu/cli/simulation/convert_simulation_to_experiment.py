"""sim-convert: simulation output → raw acquisition layout.

Mirrors `cli/statphysbio_simulation/convert_simulation_to_experiment.py`
(flat TIFF stacks → fake acquisition). The statphysbio archives are not
redistributable, so this command additionally supports ``--generate`` to
produce a hermetic synthetic experiment of the same shape (ground-truth
spots + per-bit stacks rendered through a Gaussian PSF with Poisson
noise), which the E2E/F1 harness consumes.

Raw acquisition layout written:

```
experiment/
├── metadata.json        # voxel size, wavelengths, n_bits/rounds, shape
├── codebook.csv
├── exp_order.csv
├── GT_spots.csv         # ground truth (generate mode)
└── tile0000/
    ├── fiducial_round001.npy ...
    └── bit001.npy ...
```
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import pandas as pd


def write_raw_experiment(
    out_dir: Path,
    *,
    shape=(12, 128, 128),
    n_genes=24,
    n_blanks=4,
    n_bits=16,
    n_spots=150,
    n_tiles=1,
    voxel_size_zyx_um=(0.315, 0.098, 0.098),
    seed=0,
    distribution: str = "uniform",
    n_cells: int = 6,
    axial_sigma_um: float | None = None,
    tile_offset_px=None,
    round_shift_px: float = 0.0,
    deformation_px: float = 0.0,
    chromatic_affine_zyx_um=None,
) -> Path:
    """Generate a synthetic raw acquisition (generate mode).

    ``distribution`` mirrors the statphysbio dataset families: "uniform"
    scatters spots everywhere; "cells" clusters them around ``n_cells``
    cell-like centers (reference matrix {cells, uniform},
    `tests/test_simulation_example_pipeline.py:158-183`).

    ``axial_sigma_um`` fixes the PSF's axial extent in physical units so
    coarser axial sampling (1.0 / 1.5 µm steps) renders genuinely
    undersampled spots, reproducing the reference's F1 falloff with axial
    spacing. None keeps the legacy fixed 1.4-px sigma.

    Production-geometry mode (``tile_offset_px`` set): ONE global field of
    ``n_spots`` spots and shared fiducial beads is imaged by ``n_tiles``
    overlapping tiles at stage offsets ``tile_offset_px * tile_idx``
    (stage positions recorded in metadata.json), with per-moving-round
    rigid misregistration up to ``round_shift_px`` px and a smooth global
    deformation field of amplitude ``deformation_px`` px — the full
    registration problem (staged affine + SOFIMA-style residual flow +
    stitching + overlap dedup) the statphysbio archives pose.
    ``chromatic_affine_zyx_um`` additionally renders the SECOND emission
    channel's bits through the inverse of the given 4x4 µm affine —
    chromatic aberration injected at the emitter, the same stored(p) =
    true(A·p) contract as ``convert_to_datastore``'s image-warp injection
    but with no resampling pass (a decode-time chromatic estimator must
    recover A)
    (`/root/reference/docs/examples/statphysbio_synthetic.md:13-60`).
    ``tile_offset_px=None`` keeps the legacy independent-tile rendering
    byte-identical (the pinned F1 matrix depends on it).
    """
    from ...utils.simulation import _render_bit_volume, make_mhd4_codebook

    rng = np.random.default_rng(seed)
    axial_step = float(voxel_size_zyx_um[0])
    if axial_sigma_um is not None:
        sigma_zyx = (max(float(axial_sigma_um) / axial_step, 0.25), 1.4, 1.4)
    else:
        sigma_zyx = (1.4, 1.4, 1.4)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    codebook = make_mhd4_codebook(n_genes, n_bits, n_blanks, seed=seed)
    matrix = codebook.iloc[:, 1:].to_numpy(dtype=np.float64)
    codebook.to_csv(out_dir / "codebook.csv", index=False)
    n_rounds = n_bits // 2
    eo = pd.DataFrame(
        {
            "round": np.arange(1, n_rounds + 1),
            "readout 1": np.arange(1, n_bits + 1, 2),
            "readout 2": np.arange(2, n_bits + 1, 2),
        }
    )
    eo.to_csv(out_dir / "exp_order.csv", index=False)

    gt_rows = []
    spacing = np.asarray(voxel_size_zyx_um)
    stage_positions = [[0.0, 0.0, 0.0] for _ in range(n_tiles)]
    if tile_offset_px is not None:
        gt_rows, stage_positions = _write_production_tiles(
            out_dir,
            rng,
            shape=shape,
            matrix=matrix,
            codebook=codebook,
            n_bits=n_bits,
            n_rounds=n_rounds,
            n_spots=n_spots,
            n_tiles=n_tiles,
            spacing=spacing,
            sigma_zyx=sigma_zyx,
            tile_offset_px=np.asarray(tile_offset_px, np.float64),
            round_shift_px=float(round_shift_px),
            deformation_px=float(deformation_px),
            distribution=distribution,
            n_cells=n_cells,
            chromatic_affine_zyx_um=chromatic_affine_zyx_um,
            spacing_um=np.asarray(voxel_size_zyx_um, np.float64),
        )
    legacy_tiles = range(n_tiles) if tile_offset_px is None else []
    for tile_idx in legacy_tiles:
        tdir = out_dir / f"tile{tile_idx:04d}"
        tdir.mkdir(exist_ok=True)
        margin = 8
        if distribution == "cells":
            z_lo = min(1.0, shape[0] / 4.0)
            centers = np.column_stack(
                [
                    rng.uniform(z_lo, max(shape[0] - z_lo, z_lo + 0.1), n_cells),
                    rng.uniform(margin + 6, shape[1] - margin - 6, n_cells),
                    rng.uniform(margin + 6, shape[2] - margin - 6, n_cells),
                ]
            )
            which = rng.integers(0, n_cells, n_spots)
            scatter = rng.normal(0.0, 1.0, (n_spots, 3)) * np.asarray(
                [max(shape[0] / 6.0, 1.0), 7.0, 7.0]
            )
            spots = centers[which] + scatter
            spots = np.clip(
                spots,
                [1.0, margin, margin],
                [shape[0] - 1.0, shape[1] - margin, shape[2] - margin],
            )
        elif distribution == "uniform":
            spots = np.column_stack(
                [
                    rng.uniform(2, shape[0] - 2, n_spots),
                    rng.uniform(margin, shape[1] - margin, n_spots),
                    rng.uniform(margin, shape[2] - margin, n_spots),
                ]
            )
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        genes = rng.integers(0, n_genes, n_spots)
        amps = rng.uniform(800, 2000, n_spots)
        for s in range(n_spots):
            gt_rows.append(
                {
                    "gene_id": codebook["gene_id"].iloc[genes[s]],
                    "tile_idx": tile_idx,
                    "z": spots[s, 0],
                    "y": spots[s, 1],
                    "x": spots[s, 2],
                    "global_z": spots[s, 0] * spacing[0],
                    "global_y": spots[s, 1] * spacing[1],
                    "global_x": spots[s, 2] * spacing[2],
                }
            )
        beads = np.column_stack(
            [
                rng.uniform(1, shape[0] - 1, 60),
                rng.uniform(4, shape[1] - 4, 60),
                rng.uniform(4, shape[2] - 4, 60),
            ]
        )
        fid = _render_bit_volume(
            shape, beads, rng.uniform(500, 1500, 60), sigma_zyx=sigma_zyx
        )
        for r in range(n_rounds):
            noisy = rng.poisson(fid + 40).astype(np.uint16)
            np.save(tdir / f"fiducial_round{r + 1:03d}.npy", noisy)
        for b in range(n_bits):
            on = matrix[genes, b] > 0
            vol = _render_bit_volume(
                shape, spots[on], amps[on], sigma_zyx=sigma_zyx
            )
            noisy = rng.poisson(vol + 40).astype(np.uint16)
            np.save(tdir / f"bit{b + 1:03d}.npy", noisy)

    pd.DataFrame(gt_rows).to_csv(out_dir / "GT_spots.csv", index=False)
    meta = {
        "voxel_size_zyx_um": list(voxel_size_zyx_um),
        "n_bits": n_bits,
        "n_rounds": n_rounds,
        "n_tiles": n_tiles,
        "shape_zyx": list(shape),
        "na": 1.35,
        "ri": 1.4,
        "fiducial_wavelengths_um": [0.488, 0.520],
        "bit_wavelengths_um": [
            [0.561, 0.590] if b % 2 == 0 else [0.635, 0.670] for b in range(n_bits)
        ],
        "stage_positions_zyx_um": stage_positions,
    }
    (out_dir / "metadata.json").write_text(json.dumps(meta, indent=2))
    return out_dir


def _write_production_tiles(
    out_dir: Path,
    rng,
    *,
    shape,
    matrix,
    codebook,
    n_bits: int,
    n_rounds: int,
    n_spots: int,
    n_tiles: int,
    spacing,
    sigma_zyx,
    tile_offset_px,
    round_shift_px: float,
    deformation_px: float,
    distribution: str,
    n_cells: int,
    chromatic_affine_zyx_um=None,
    spacing_um=None,
):
    """Production-geometry renderer: one global spot/bead field imaged by
    overlapping tiles, with per-moving-round rigid shifts and a smooth
    global deformation field (see ``write_raw_experiment`` docstring)."""
    from ...utils.simulation import _render_bit_volume

    shape = np.asarray(shape, int)
    offsets_px = [tile_offset_px * t for t in range(n_tiles)]
    extent_px = shape.astype(np.float64) + offsets_px[-1]
    margin = 8

    n_genes_total = matrix.shape[0]
    coding = [
        i
        for i in range(n_genes_total)
        if not str(codebook["gene_id"].iloc[i]).lower().startswith("blank")
    ]
    if distribution == "cells":
        centers = np.column_stack(
            [
                rng.uniform(1.0, extent_px[0] - 1.0, n_cells),
                rng.uniform(margin + 6, extent_px[1] - margin - 6, n_cells),
                rng.uniform(margin + 6, extent_px[2] - margin - 6, n_cells),
            ]
        )
        which = rng.integers(0, n_cells, n_spots)
        scatter = rng.normal(0.0, 1.0, (n_spots, 3)) * np.asarray(
            [max(shape[0] / 6.0, 1.0), 30.0, 30.0]
        )
        global_spots = np.clip(
            centers[which] + scatter,
            [1.0, margin, margin],
            [extent_px[0] - 1.0, extent_px[1] - margin, extent_px[2] - margin],
        )
    else:
        global_spots = np.column_stack(
            [
                rng.uniform(2, extent_px[0] - 2, n_spots),
                rng.uniform(margin, extent_px[1] - margin, n_spots),
                rng.uniform(margin, extent_px[2] - margin, n_spots),
            ]
        )
    genes = np.asarray(coding)[rng.integers(0, len(coding), n_spots)]
    amps = rng.uniform(800, 2000, n_spots)

    n_beads = 80 * n_tiles
    global_beads = np.column_stack(
        [
            rng.uniform(1, extent_px[0] - 1, n_beads),
            rng.uniform(4, extent_px[1] - 4, n_beads),
            rng.uniform(4, extent_px[2] - 4, n_beads),
        ]
    )
    bead_amps = rng.uniform(500, 1500, n_beads)

    # per-moving-round rigid shift (z scaled down: stage drift is mostly
    # lateral) and deformation-field phases; round 0 is the reference
    shifts = np.zeros((n_rounds, 3))
    phases = np.zeros((n_rounds, 4))
    for r in range(1, n_rounds):
        shifts[r] = rng.uniform(-1.0, 1.0, 3) * round_shift_px * np.asarray(
            [0.25, 1.0, 1.0]
        )
        phases[r] = rng.uniform(0, 2 * np.pi, 4)

    def deform(points_global, r):
        """Smooth low-frequency displacement (px) of global positions in
        round r's frame — what SOFIMA's residual flow must recover."""
        if r == 0 or deformation_px == 0.0:
            return np.zeros_like(points_global)
        z, y, x = points_global.T
        ly = max(float(extent_px[1]), 1.0)
        lx = max(float(extent_px[2]), 1.0)
        dy = deformation_px * np.sin(
            2 * np.pi * x / lx + phases[r, 0]
        ) * np.cos(2 * np.pi * y / ly + phases[r, 1])
        dx = deformation_px * np.cos(
            2 * np.pi * y / ly + phases[r, 2]
        ) * np.sin(2 * np.pi * x / lx + phases[r, 3])
        dz = 0.25 * deformation_px * np.sin(2 * np.pi * x / lx + phases[r, 0])
        return np.column_stack([dz, dy, dx])

    gt_rows = []
    for s in range(n_spots):
        z, y, x = global_spots[s]
        gt_rows.append(
            {
                "gene_id": codebook["gene_id"].iloc[genes[s]],
                "tile_idx": -1,
                "z": z,
                "y": y,
                "x": x,
                "global_z": z * spacing[0],
                "global_y": y * spacing[1],
                "global_x": x * spacing[2],
            }
        )

    # record the injected truth for diagnosis harnesses (GT_misregistration)
    (out_dir / "GT_misregistration.json").write_text(
        json.dumps(
            {
                "round_shifts_px_zyx": shifts.tolist(),
                "deformation_px": float(deformation_px),
                "chromatic_affine_zyx_um": (
                    np.asarray(chromatic_affine_zyx_um).tolist()
                    if chromatic_affine_zyx_um is not None
                    else None
                ),
            }
        )
    )

    stage_positions = []
    shape_t = tuple(int(v) for v in shape)
    for tile_idx in range(n_tiles):
        tdir = out_dir / f"tile{tile_idx:04d}"
        tdir.mkdir(exist_ok=True)
        offset = offsets_px[tile_idx]
        stage_positions.append([float(v) for v in offset * spacing])

        for r in range(n_rounds):
            # bead positions as round r images them: global + rigid shift
            # + deformation, then into this tile's frame
            moved = global_beads + shifts[r] + deform(global_beads, r)
            local = moved - offset
            inside = np.all(
                (local > -5) & (local < shape.astype(float) + 5), axis=1
            )
            fid = _render_bit_volume(
                shape_t, local[inside], bead_amps[inside], sigma_zyx=sigma_zyx
            )
            noisy = rng.poisson(fid + 40).astype(np.uint16)
            np.save(tdir / f"fiducial_round{r + 1:03d}.npy", noisy)

        inv_chromatic = (
            np.linalg.inv(np.asarray(chromatic_affine_zyx_um, np.float64))
            if chromatic_affine_zyx_um is not None
            else None
        )
        for b in range(n_bits):
            r = b // 2  # exp_order round link
            on = matrix[genes, b] > 0
            moved = (
                global_spots[on] + shifts[r] + deform(global_spots[on], r)
            )
            if inv_chromatic is not None and b % 2 == 1:
                # second emission channel: emitter appears at A⁻¹·q
                # (stored(p) = true(A·p)); the affine acts on physical µm
                # coordinates in this tile's frame, matching the stored
                # chromatic transform contract the decoder inverts
                local_um = (moved - offset) * spacing_um
                local_um = local_um @ inv_chromatic[:3, :3].T + inv_chromatic[:3, 3]
                moved = local_um / spacing_um + offset
            local = moved - offset
            inside = np.all(
                (local > -5) & (local < shape.astype(float) + 5), axis=1
            )
            vol = _render_bit_volume(
                shape_t, local[inside], amps[on][inside], sigma_zyx=sigma_zyx
            )
            noisy = rng.poisson(vol + 40).astype(np.uint16)
            np.save(tdir / f"bit{b + 1:03d}.npy", noisy)

    return gt_rows, stage_positions


def convert_tiffs(input_dir: Path, out_dir: Path) -> Path:
    """Convert a directory of per-bit TIFF stacks into the raw layout
    (PIL-based multipage TIFF reader; tifffile is not available)."""
    from PIL import Image

    input_dir, out_dir = Path(input_dir), Path(out_dir)
    tdir = out_dir / "tile0000"
    tdir.mkdir(parents=True, exist_ok=True)
    for tif in sorted(input_dir.glob("*.tif*")):
        img = Image.open(tif)
        frames = []
        for i in range(getattr(img, "n_frames", 1)):
            img.seek(i)
            frames.append(np.asarray(img))
        np.save(tdir / (tif.stem + ".npy"), np.stack(frames))
    for aux in ("codebook.csv", "exp_order.csv", "GT_spots.csv", "metadata.json"):
        src = input_dir / aux
        if src.exists():
            (out_dir / aux).write_bytes(src.read_bytes())
    return out_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sim-convert")
    p.add_argument("--input-dir", type=Path, default=None)
    p.add_argument("--output-dir", required=True, type=Path)
    p.add_argument("--generate", action="store_true", help="generate synthetic data")
    p.add_argument("--shape-zyx", type=int, nargs=3, default=(12, 128, 128))
    p.add_argument("--n-spots", type=int, default=150)
    p.add_argument("--n-genes", type=int, default=24)
    p.add_argument("--n-bits", type=int, default=16)
    p.add_argument("--n-tiles", type=int, default=1)
    p.add_argument("--axial-step-um", type=float, default=0.315)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--distribution", choices=("uniform", "cells"), default="uniform"
    )
    p.add_argument("--axial-sigma-um", type=float, default=None)
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    if args.generate:
        write_raw_experiment(
            args.output_dir,
            shape=tuple(args.shape_zyx),
            n_spots=args.n_spots,
            n_genes=args.n_genes,
            n_bits=args.n_bits,
            n_tiles=args.n_tiles,
            voxel_size_zyx_um=(args.axial_step_um, 0.098, 0.098),
            seed=args.seed,
            distribution=args.distribution,
            axial_sigma_um=args.axial_sigma_um,
        )
    else:
        if args.input_dir is None:
            raise SystemExit("--input-dir required unless --generate")
        convert_tiffs(args.input_dir, args.output_dir)


if __name__ == "__main__":
    main()
