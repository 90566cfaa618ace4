"""Test configuration: an 8-device virtual CPU mesh unless the caller
chose a platform.

The suite runs on the CPU, where multi-card sharding paths run on virtual
CPU devices. Tests marked ``chip`` need the GPU and skip elsewhere; run
them on a GPU machine with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip``
(the CPU stays available as their reference device).
"""

import os

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from merfish3d_tpu.utils.jaxcache import enable_persistent_cache

# hundreds of jitted programs recompile identically on every pytest run;
# the persistent cache turns rerun compile time into disk loads
enable_persistent_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, so every pytest worker collects the same tests."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu -m chip)")
    return jax.devices()[0]


def pytest_addoption(parser):
    parser.addoption(
        "--run-f1-exhaustive",
        action="store_true",
        default=False,
        help="run the exhaustive F1 matrix (decon at coarse axial spacings)",
    )
    parser.addoption(
        "--run-f1-production",
        action="store_true",
        default=False,
        help=(
            "run the full production-geometry case (2x(16,1024,1024) "
            "tiles, deformable + chromatic; ~1h on a single CPU core)"
        ),
    )
