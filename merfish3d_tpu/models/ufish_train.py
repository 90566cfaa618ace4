"""Train a :class:`UFishNet` spot-probability model on synthetic data.

The published U-FISH checkpoints cannot be fetched in a zero-egress
environment, so this module provides the other path to a working CNN
predictor: supervised training on synthetic spot renders (the same
generative model the U-FISH authors trained on — point emitters through
a Gaussian PSF with Poisson noise, target = probability blobs at the
true positions). A few hundred optax steps on small planes produce a
usable model; experiment-matched retraining is the recommended route for
production accuracy when the published weights are unavailable.

Reference context: `DataRegistration.py:60-68,886-899` (ONNX inference);
the training recipe mirrors U-FISH's published setup (2D planes,
per-plane percentile normalization, BCE on a Gaussian target map).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .ufish import UFishPredictor, _percentile_normalize
from .ufish_flax import UFishNet


def render_training_batch(
    rng: np.random.Generator,
    *,
    batch: int = 8,
    size: int = 64,
    max_spots: int = 12,
    min_spots: int = 1,
    sigma: float = 1.4,
    target_sigma: float = 1.0,
    amplitude=(300.0, 2000.0),
    background: float = 40.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(planes, targets): Poisson-noised Gaussian-spot planes and their
    probability-map targets (Gaussian blobs at the true positions).

    The spot-count range sets the training planes' NORMALIZED appearance:
    the per-plane percentile normalization (`_percentile_normalize`, the
    same transform applied at inference) puts its 99.8% anchor inside the
    spot intensity range on dense small planes but on the background
    noise tail of sparse production-size planes — a model trained at one
    density regime misreads the other (measured: the 64-px/12-spot
    checkpoint floods production-size planes with junk probability).
    Train with the plane size and density matched to the target data."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    planes = np.zeros((batch, size, size), np.float32)
    targets = np.zeros((batch, size, size), np.float32)
    for b in range(batch):
        n = rng.integers(min_spots, max_spots + 1)
        ys = rng.uniform(3, size - 3, n)
        xs = rng.uniform(3, size - 3, n)
        amps = rng.uniform(*amplitude, n)
        img = np.zeros((size, size), np.float64)
        tgt = np.zeros((size, size), np.float64)
        for y, x, a in zip(ys, xs, amps):
            d2 = (yy - y) ** 2 + (xx - x) ** 2
            img += a * np.exp(-d2 / (2 * sigma**2))
            tgt = np.maximum(tgt, np.exp(-d2 / (2 * target_sigma**2)))
        planes[b] = rng.poisson(img + background)
        targets[b] = tgt
    return planes, targets


def train_ufish(
    *,
    steps: int = 300,
    batch: int = 8,
    size: int = 64,
    base_features: int = 8,
    learning_rate: float = 3e-3,
    seed: int = 0,
    spot_sigma: float = 1.4,
    max_spots: int = 12,
    min_spots: int = 1,
    verbose: bool = False,
) -> dict:
    """Train UFishNet on synthetic spot planes; returns Flax variables."""
    net = UFishNet(base_features=base_features)
    key = jax.random.PRNGKey(seed)
    variables = net.init(key, jnp.zeros((1, size, size, 1), jnp.float32))
    tx = optax.adam(learning_rate)
    opt_state = tx.init(variables["params"])

    @jax.jit
    def step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            out, updates = net.apply(
                {"params": p, "batch_stats": batch_stats},
                x,
                mutable=["batch_stats"],
            )
            # sigmoid output -> binary cross-entropy against the target map
            eps = 1e-6
            out = jnp.clip(out[..., 0], eps, 1 - eps)
            bce = -(y * jnp.log(out) + (1 - y) * jnp.log(1 - out))
            # weight spot pixels up: they are a tiny fraction of the plane
            w = 1.0 + 20.0 * y
            return jnp.mean(w * bce), updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, new_stats, opt_state, loss

    rng = np.random.default_rng(seed)
    params = variables["params"]
    batch_stats = variables["batch_stats"]
    norm = jax.jit(jax.vmap(_percentile_normalize))
    for i in range(steps):
        planes, targets = render_training_batch(
            rng, batch=batch, size=size, sigma=spot_sigma,
            max_spots=max_spots, min_spots=min_spots,
        )
        x = norm(jnp.asarray(planes))[..., None]
        params, batch_stats, opt_state, loss = step(
            params, batch_stats, opt_state, x, jnp.asarray(targets)
        )
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"ufish train step {i}: loss {float(loss):.4f}", flush=True)
    return {"params": params, "batch_stats": batch_stats}


def train_predictor(
    *, steps: int = 300, base_features: int = 8, seed: int = 0, **kwargs
) -> UFishPredictor:
    """Train and wrap as a :class:`UFishPredictor`."""
    variables = train_ufish(
        steps=steps, base_features=base_features, seed=seed, **kwargs
    )
    return UFishPredictor(params=variables, base_features=base_features)


def save_variables(variables: dict, path) -> None:
    import pickle

    with open(path, "wb") as fh:
        pickle.dump(jax.tree.map(np.asarray, variables), fh)
