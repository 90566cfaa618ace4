"""`chip_smoke.py` on the CPU: it refuses to report without a GPU, and
each phase-1 comparison runs end to end at toy size (the CPU standing in
for the card), so its logic and tolerances are exercised before a chip
run. The toy runs measure nothing."""

import json
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    yx=128, rlgc_z=6, rlgc_ref_z=4, rlgc_ref_iters=2, rlgc_time_iters=3,
    psf=(7, 9, 9), pc_z=8, flow_z=12, flow_period=128.0, ufish_planes=2,
    decode_bits=16, decode_z=8, decode_ref_z=3,
)


def test_refuses_cpu_backend(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert "{" not in out  # no result line


def test_cache_path_and_card_query_are_reported(monkeypatch):
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "stub card, 700.00 W")
    assert chip_smoke.phase0() == "stub card, 700.00 W"


@pytest.mark.parametrize(
    "check", ["rlgc", "phase_corr", "flow_warp", "ufish", "lowpass_decode"]
)
def test_phase1_check_passes_at_toy_size(check):
    cpu = jax.devices("cpu")[0]
    checks = chip_smoke.Checks("toy")
    if check == "rlgc":
        chip_smoke.check_rlgc(TINY, checks, cpu)
    elif check == "phase_corr":
        chip_smoke.check_phase_corr(TINY, checks)
    elif check == "flow_warp":
        chip_smoke.check_flow_warp(TINY, checks, cpu)
    elif check == "ufish":
        chip_smoke.check_ufish(TINY, checks, cpu)
    else:
        chip_smoke.check_lowpass_decode(TINY, checks)
    checks.finish()


def test_failed_check_fails_the_phase():
    checks = chip_smoke.Checks("toy")
    checks.check("within", 0.5, 1.0)
    checks.finish()
    checks.check("outside", 2.0, 1.0)
    checks.check("not finite", float("nan"), 1.0)
    with pytest.raises(AssertionError, match="outside, not finite"):
        checks.finish()


def test_result_line_shape(monkeypatch, capsys):
    """With a GPU the last line is the one JSON object the driver reads;
    here the device probe is stubbed and the phases skipped."""

    class FakeDevice:
        platform, device_kind = "gpu", "Stub GPU"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    monkeypatch.setattr(chip_smoke, "phase0", lambda: "Stub GPU, 700.00 W")
    monkeypatch.setattr(chip_smoke, "phase1", lambda: None)
    monkeypatch.setattr(chip_smoke, "phase2", lambda clock: None)
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "card: Stub GPU, 700.00 W"
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "Stub GPU", "count": 1}
    }


def test_failed_phase_runs_the_next_and_fails_the_run(monkeypatch, capsys):
    """A phase that raises does not stop the next phase, and the run then
    exits non-zero with no result line."""

    class FakeDevice:
        platform, device_kind = "gpu", "Stub GPU"

    ran = []

    def broken():
        raise AssertionError("phase1 failed: stub")

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    monkeypatch.setattr(chip_smoke, "phase0", lambda: "Stub GPU, 700.00 W")
    monkeypatch.setattr(chip_smoke, "phase1", broken)
    monkeypatch.setattr(chip_smoke, "phase2", lambda clock: ran.append("phase2"))
    assert chip_smoke.main([]) == 1
    assert ran == ["phase2"]
    assert "{" not in capsys.readouterr().out


@pytest.mark.chip
@pytest.mark.parametrize(
    "check", ["rlgc", "phase_corr", "flow_warp", "ufish", "lowpass_decode"]
)
def test_phase1_check_on_the_gpu_at_toy_size(gpu, check):
    """The same comparisons with the GPU under test and the CPU as the
    reference (``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip``)."""
    cpu = jax.devices("cpu")[0]
    checks = chip_smoke.Checks("toy-gpu")
    with jax.default_device(gpu):
        if check == "rlgc":
            chip_smoke.check_rlgc(TINY, checks, cpu)
        elif check == "phase_corr":
            chip_smoke.check_phase_corr(TINY, checks)
        elif check == "flow_warp":
            chip_smoke.check_flow_warp(TINY, checks, cpu)
        elif check == "ufish":
            chip_smoke.check_ufish(TINY, checks, cpu)
        else:
            chip_smoke.check_lowpass_decode(TINY, checks)
    checks.finish()
