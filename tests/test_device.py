"""`device.py` budgets and the compile-cache location."""

import jax
import pytest

from merfish3d_tpu import device
from merfish3d_tpu.utils import jaxcache

GIB = 1 << 30


def test_describe_names_the_backend():
    d = device.describe()
    assert d == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_cpu_reports_the_reference_limit():
    """The CPU backend reports no memory limit and is budgeted as the
    16 GiB reference device, so the CPU tests keep the original budgets."""
    assert device.bytes_limit() == device.REFERENCE_BYTES_LIMIT == 16 * GIB
    assert device.scale_budget(12 * GIB) == 12 * GIB


@pytest.mark.parametrize(
    "limit,expected_scale",
    [(16 * GIB, 1.0), (80 * GIB, 5.0), (63763120128, 63763120128 / (16 * GIB))],
    ids=["16GiB", "80GiB", "h100-default-fraction"],
)
def test_budgets_scale_with_the_limit(monkeypatch, limit, expected_scale):
    monkeypatch.setattr(device, "bytes_limit", lambda: limit)
    assert device.scale_budget(10 * GIB) == pytest.approx(10 * GIB * expected_scale)


@pytest.mark.parametrize("limit,untiled", [(16 * GIB, False), (80 * GIB, True)])
def test_rlgc_crop_follows_the_budget(monkeypatch, limit, untiled):
    """A (50, 2048, 2048) camera tile tiles laterally on a 16 GiB device
    and solves whole on an 80 GiB one."""
    from merfish3d_tpu.ops import rlgc

    monkeypatch.setattr(device, "bytes_limit", lambda: limit)
    crop = rlgc.auto_crop_yx((50, 2048, 2048), (15, 31, 31))
    assert (crop >= 2048) == untiled


@pytest.mark.parametrize("limit", [16 * GIB, 80 * GIB])
def test_decode_stack_residency_follows_the_budget(monkeypatch, limit):
    """A 16-bit (50, 1024, 1024) float32 stack (3.4 GB) stays on an
    80 GiB device for decode, not on a 16 GiB one; a small one on both."""
    from merfish3d_tpu.pipeline import decoder

    monkeypatch.setattr(device, "bytes_limit", lambda: limit)
    big = 16 * 50 * 1024 * 1024 * 4
    assert decoder._stack_fits_device(big) == (limit == 80 * GIB)
    assert decoder._stack_fits_device(16 * 16 * 256 * 256 * 4)


@pytest.mark.parametrize(
    "env,expected",
    [(None, jaxcache.DEFAULT_CACHE_DIR), ("", jaxcache.DEFAULT_CACHE_DIR),
     ("/some/cache", "/some/cache")],
    ids=["unset", "empty", "set"],
)
def test_cache_dir_resolution(monkeypatch, env, expected):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert str(jaxcache.cache_dir()) == str(expected)


def test_default_cache_is_inside_the_checkout():
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    assert jaxcache.DEFAULT_CACHE_DIR == repo / ".jax_cache"


def test_enable_uses_the_env_dir_and_nothing_else(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert jaxcache.enable_persistent_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
