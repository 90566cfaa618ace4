"""Pinned F1 regression matrix over the REAL pipeline.

Analog of the reference's standard simulation matrix with exact
expected values (`tests/test_simulation_example_pipeline.py:158-183,
244-313`, tolerance ±0.02 `:47`): {cells, uniform} x {0.315, 1.0, 1.5 um
axial} no-decon, plus {cells, uniform} x 0.315 um with RLGC decon. Each
case runs generate -> datastore -> register(+global) -> decode -> F1 in
an isolated workspace. A silent F1 drift beyond ±0.02 fails.

The pins are this pipeline's own deterministic outputs (fixed seeds,
fixed thresholds) — the reference's published numbers are tied to its
datasets and U-FISH checkpoints, which are not redistributable; what is
replicated is the matrix structure, the exact-pin methodology, and the
characteristic F1 falloff with axial undersampling.
"""

import pytest

from f1_matrix_common import (
    EXHAUSTIVE_MATRIX,
    STANDARD_MATRIX,
    MatrixCase,
    run_matrix_case,
)

F1_ABS_TOLERANCE = 0.02  # reference `tests/test_simulation_example_pipeline.py:47`

# exact pins (CPU, fixed seeds), re-pinned in r3 after root-causing the
# r2 gap (docs/f1_ablation.md): the DoG fallback's sigmoid operating
# point at 2 MAD enhanced Poisson noise peaks into decodable junk, which
# flooded the blank-fraction filter and collapsed the iterative
# normalization medians. Moving it to 5 MAD lifted every case to >= 0.91
# — matching the reference's standard-matrix shape (its worst standard
# cell is 0.79; README.md:130-137) with no coarse-spacing collapse.
# Re-pinned in r5 after two deliberate changes (VERDICT r4 #2a/#5):
# (1) spot-sparse normalization seeding moved to the down-biased
# spot-core recipe (`decoder._seed_stats_program`), which starts the
# optimizer 1-2 climb iterations below converged instead of ~100x low; (2) the uniform cases
# now render 170 spots instead of 60 (`f1_matrix_common.MatrixCase.
# n_spots`) — at 60 every uniform pin saturated at exactly 1.0000 and
# could detect no regression. All 12 pins now sit off the ceiling in
# 0.89-0.96, inside the reference's standard band (its standard cells
# span 0.79-0.99, `README.md:130-137`).
EXPECTED_F1 = {
    "cells-0.315um-nodecon": 0.9474,
    "cells-1.0um-nodecon": 0.9474,
    "cells-1.5um-nodecon": 0.9381,
    "uniform-0.315um-nodecon": 0.9480,
    "uniform-1.0um-nodecon": 0.9297,
    "uniform-1.5um-nodecon": 0.9379,
    "cells-0.315um-decon": 0.9655,
    "uniform-0.315um-decon": 0.9573,
    # exhaustive mode: decon at coarse axial spacing does not collapse
    # (the reference documents cells/1.5 decon = 0.377 on its data; the
    # r2 collapse HERE was junk-FP driven, not decon physics — ablation
    # table in docs/f1_ablation.md)
    "cells-1.0um-decon": 0.9655,
    "cells-1.5um-decon": 0.9565,
    "uniform-1.0um-decon": 0.9541,
    "uniform-1.5um-decon": 0.9415,
}


@pytest.mark.parametrize(
    "case", STANDARD_MATRIX, ids=[c.case_id for c in STANDARD_MATRIX]
)
def test_f1_matrix_case(case: MatrixCase, tmp_path):
    result = run_matrix_case(case, tmp_path)
    expected = EXPECTED_F1[case.case_id]
    assert abs(result["f1"] - expected) <= F1_ABS_TOLERANCE, (
        f"{case.case_id}: F1 {result['f1']:.4f} drifted from pinned "
        f"{expected:.4f} (tp={result['true_positives']} "
        f"fp={result['false_positives']} fn={result['false_negatives']})"
    )


# CNN-path pins: the SAME pipeline with a real UFishNet checkpoint
# (trained on synthetic spot renders, `models/ufish_train.py`,
# `tests/data/ufish_synthetic_c8.pkl` — seed 0, 600 steps, c8) doing the
# probability prediction end-to-end instead of the DoG fallback. The CNN
# path must match or beat the DoG pin on the same case (VERDICT r3 #2).
CNN_CASES = [
    MatrixCase("cells", 0.315, True),
    MatrixCase("uniform", 0.315, False),
]
EXPECTED_F1_CNN = {
    "cells-0.315um-decon": 0.9744,
    "uniform-0.315um-nodecon": 0.9666,
}


@pytest.mark.parametrize(
    "case", CNN_CASES, ids=[c.case_id + "-cnn" for c in CNN_CASES]
)
def test_f1_matrix_cnn_case(case: MatrixCase, tmp_path):
    from pathlib import Path

    ckpt = Path(__file__).parent / "data" / "ufish_synthetic_c8.pkl"
    result = run_matrix_case(case, tmp_path, ufish_checkpoint=ckpt)
    expected = EXPECTED_F1_CNN[case.case_id]
    assert abs(result["f1"] - expected) <= F1_ABS_TOLERANCE, (
        f"{case.case_id} (CNN): F1 {result['f1']:.4f} drifted from pinned "
        f"{expected:.4f} (tp={result['true_positives']} "
        f"fp={result['false_positives']} fn={result['false_negatives']})"
    )
    # the CNN predictor must not regress below the DoG pin on this case
    assert result["f1"] >= EXPECTED_F1[case.case_id] - F1_ABS_TOLERANCE


@pytest.mark.parametrize(
    "case", EXHAUSTIVE_MATRIX, ids=[c.case_id for c in EXHAUSTIVE_MATRIX]
)
def test_f1_matrix_exhaustive_case(case: MatrixCase, tmp_path, request):
    """Opt-in exhaustive cells (pytest --run-f1-exhaustive), mirroring the
    reference's exhaustive-mode marker machinery."""
    if not request.config.getoption("--run-f1-exhaustive"):
        pytest.skip("exhaustive matrix: pass --run-f1-exhaustive")
    result = run_matrix_case(case, tmp_path)
    expected = EXPECTED_F1[case.case_id]
    assert abs(result["f1"] - expected) <= F1_ABS_TOLERANCE, (
        f"{case.case_id}: F1 {result['f1']:.4f} drifted from pinned "
        f"{expected:.4f}"
    )
