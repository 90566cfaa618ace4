"""U-FISH inference through plain lax (`models/ufish._LaxUNet`) against
the Flax module it mirrors (`models/ufish_flax.UFishNet`)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from merfish3d_tpu.models import ufish as m


def _variables(up_mode, base=8, seed=3):
    """Random variables with non-trivial BatchNorm state, so the fold is
    exercised."""
    v = m.init_unet_variables(jax.random.PRNGKey(seed), base, (1, 2, 4), up_mode)
    rng = np.random.default_rng(seed)
    v["params"] = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a,
        v["params"],
    )
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    return v


@pytest.mark.parametrize("up_mode", ["resize", "convtranspose"])
@pytest.mark.parametrize("hw", [(32, 32), (16, 48)])
def test_lax_unet_matches_flax_apply(up_mode, hw):
    from merfish3d_tpu.models.ufish_flax import UFishNet

    v = _variables(up_mode)
    x = jnp.asarray(np.random.default_rng(1).random((2, *hw, 1)), jnp.float32)
    ref = UFishNet(base_features=8, up_mode=up_mode).apply(v, x)
    got = m._LaxUNet(v, 8, (1, 2, 4), up_mode)(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("up_mode", ["resize", "convtranspose"])
def test_init_variables_match_flax_layout(up_mode):
    """Random init has the Flax tree, shapes and dtypes, so trained or
    converted checkpoints and fresh predictors are interchangeable."""
    from merfish3d_tpu.models.ufish_flax import UFishNet

    ours = m.init_unet_variables(jax.random.PRNGKey(0), 8, (1, 2, 4), up_mode)
    flax_v = UFishNet(base_features=8, up_mode=up_mode).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1))
    )
    spec = lambda t: jax.tree.map(lambda a: (a.shape, str(a.dtype)), t)  # noqa: E731
    assert spec(ours) == spec(jax.device_get(flax_v))


def test_predictor_infers_topology_and_predicts_probabilities():
    v = _variables("convtranspose", base=4)
    pred = m.UFishPredictor(params=v, pad_to=16)
    assert pred.net == m.UNetTopology(4, (1, 2, 4), "convtranspose")
    prob = pred.predict(np.random.default_rng(0).random((3, 20, 28)) * 500)
    assert prob.shape == (3, 20, 28)
    assert np.all((prob >= 0) & (prob <= 1))


def test_inference_module_does_not_import_flax():
    """U-FISH inference runs where Flax is not installed."""
    code = (
        "import sys; import merfish3d_tpu.models.ufish as m; "
        "m.UFishPredictor().predict(__import__('numpy').zeros((1, 16, 16))); "
        "assert 'flax' not in sys.modules, 'flax imported'"
    )
    import subprocess

    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
