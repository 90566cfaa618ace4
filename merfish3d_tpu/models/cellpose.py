"""Native flow-field cell segmentation (Cellpose-family algorithm).

The reference delegates segmentation to Cellpose-SAM run on the fused
fiducial max projection (`/root/reference/src/merfish3danalysis/cli/
qi2lab_microscopes/segment_fiducial.py:24-270`) — an external torch
model.  This module provides a native JAX path with the same
algorithmic contract Cellpose defined:

1. a residual U-Net (``CPNet``) predicts a 2-channel spatial flow field
   pointing toward each cell's center plus a cell-probability logit,
2. every foreground pixel is advected along the predicted flow with
   jitted Euler steps (``follow_flows`` — bilinear flow sampling via
   `map_coordinates`, a fixed-trip `lax.fori_loop`),
3. pixels that converged to the same sink become one cell
   (``flows_to_masks`` — host-side landing histogram + labeling, the
   same host/device split as the decoder's component extraction).

This splits touching cells the way no threshold/watershed fallback can:
the flow field is a learned shape prior.  ``train_cpnet`` provides the
synthetic-supervision route to working weights (the same strategy as
`ufish_train` for the spot CNN: zero-egress environments cannot fetch
published checkpoints).

The pipeline entry is ``flow_segment`` (wired as
``segment_fiducial(..., method="flow")`` and ``qi2lab-segment
--method flow``); external Cellpose masks remain accepted via
``--mask-path`` (SURVEY.md §2.8 interop contract).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn


# ---------------------------------------------------------------------------
# network


class CPResBlock(nn.Module):
    """Residual double-conv block: conv3x3→BN→relu ×2 + projected skip."""

    features: int

    @nn.compact
    def __call__(self, x):
        skip = x
        if skip.shape[-1] != self.features:
            skip = nn.Conv(self.features, (1, 1), use_bias=False)(skip)
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        x = nn.relu(x)
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        return nn.relu(x + skip)


class CPNet(nn.Module):
    """Cellpose-family residual U-Net.

    Encoder: one ``CPResBlock`` per level with 2x2 max-pool between
    levels.  A global style vector (L2-normalized mean pool of the
    deepest features, Cellpose's shape-prior mechanism) is projected
    into every decoder level.  Decoder: nearest-resize upsampling +
    skip concatenation + ``CPResBlock``.  Head: 1x1 conv to
    ``(flow_y, flow_x, cellprob_logit)``.
    """

    base_features: int = 32
    mults: Sequence[int] = (1, 2, 4, 8)

    @nn.compact
    def __call__(self, x):  # x: (B, H, W, 1) -> (B, H, W, 3)
        feats = [self.base_features * m for m in self.mults]
        skips = []
        for f in feats[:-1]:
            x = CPResBlock(f)(x)
            skips.append(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = CPResBlock(feats[-1])(x)
        style = jnp.mean(x, axis=(1, 2))  # (B, C)
        style = style / jnp.maximum(
            jnp.linalg.norm(style, axis=-1, keepdims=True), 1e-6
        )
        for f, skip in zip(reversed(feats[:-1]), reversed(skips)):
            b, h, w, c = x.shape
            x = jax.image.resize(x, (b, h * 2, w * 2, c), method="nearest")
            x = nn.Conv(f, (2, 2), padding="SAME")(x)
            x = jnp.concatenate([x, skip], axis=-1)
            x = x + nn.Dense(x.shape[-1])(style)[:, None, None, :]
            x = CPResBlock(f)(x)
        return nn.Conv(3, (1, 1))(x)


def init_cpnet(net: CPNet, seed: int = 0, size: int = 64) -> dict:
    dummy = jnp.zeros((1, size, size, 1), jnp.float32)
    return jax.jit(lambda k, d: net.init(k, d))(jax.random.PRNGKey(seed), dummy)


# ---------------------------------------------------------------------------
# ground-truth flows (training supervision + follower tests)


def masks_to_flows(masks: np.ndarray) -> np.ndarray:
    """Center flows from a label mask: unit vectors from each pixel toward
    its cell's centroid (the training target; Cellpose derives flows from
    heat diffusion — the centroid field is its fixed point for convex
    cells and is exact for the synthetic training shapes)."""
    masks = np.asarray(masks)
    flows = np.zeros((2,) + masks.shape, np.float32)
    yy, xx = np.meshgrid(
        np.arange(masks.shape[0]), np.arange(masks.shape[1]), indexing="ij"
    )
    for cell in np.unique(masks):
        if cell == 0:
            continue
        sel = masks == cell
        cy, cx = yy[sel].mean(), xx[sel].mean()
        dy, dx = cy - yy[sel], cx - xx[sel]
        norm = np.maximum(np.sqrt(dy**2 + dx**2), 1e-6)
        flows[0][sel] = dy / norm
        flows[1][sel] = dx / norm
    return flows


# ---------------------------------------------------------------------------
# flow following (device) + mask reconstruction (host)


@jax.jit
def follow_flows(
    flows: jnp.ndarray, fg: jnp.ndarray, n_iter: int = 100, step: float = 1.0
) -> jnp.ndarray:
    """Advect every pixel along the flow field for ``n_iter`` Euler steps.

    flows: (2, H, W) — (dy, dx) pointing toward cell centers.
    fg: (H, W) bool — background pixels do not move.
    Returns (2, H, W) final (y, x) positions.  Fixed trip count + static
    shapes: one compiled program regardless of content."""
    h, w = flows.shape[1:]
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    pos = jnp.stack([yy, xx]).astype(jnp.float32)  # (2, H, W)
    gate = fg.astype(jnp.float32)

    def body(_, p):
        fy = jax.scipy.ndimage.map_coordinates(flows[0], list(p), order=1)
        fx = jax.scipy.ndimage.map_coordinates(flows[1], list(p), order=1)
        py = jnp.clip(p[0] + step * gate * fy, 0.0, h - 1.0)
        px = jnp.clip(p[1] + step * gate * fx, 0.0, w - 1.0)
        return jnp.stack([py, px])

    return jax.lax.fori_loop(0, n_iter, body, pos)


def flows_to_masks(
    final_pos: np.ndarray,
    fg: np.ndarray,
    *,
    min_area: int = 30,
    min_sink_mass: int = 9,
) -> np.ndarray:
    """Cluster converged pixels into cells (host).

    Pixels landing in the same sink region (landing-histogram support,
    dilated by 1 px and labeled) share a cell id; sinks that attracted
    fewer than ``min_sink_mass`` pixels are noise."""
    import scipy.ndimage

    fg = np.asarray(fg, bool)
    pos = np.round(np.asarray(final_pos)).astype(np.int64)
    pos[0] = np.clip(pos[0], 0, fg.shape[0] - 1)
    pos[1] = np.clip(pos[1], 0, fg.shape[1] - 1)
    land_y, land_x = pos[0][fg], pos[1][fg]
    hist = np.zeros(fg.shape, np.int64)
    np.add.at(hist, (land_y, land_x), 1)
    sinks = scipy.ndimage.binary_dilation(hist > 0, iterations=1)
    sink_labels, n = scipy.ndimage.label(sinks)
    if n == 0:
        return np.zeros(fg.shape, np.int32)
    mass = np.bincount(
        sink_labels.ravel(), weights=hist.ravel(), minlength=n + 1
    )
    keep = np.zeros(n + 1, bool)
    keep[1:] = mass[1:] >= min_sink_mass
    sink_labels[~keep[sink_labels]] = 0
    labels = np.zeros(fg.shape, np.int32)
    labels[fg] = sink_labels[land_y, land_x]
    if labels.max():
        counts = np.bincount(labels.ravel())
        small = np.where(counts < min_area)[0]
        labels[np.isin(labels, small)] = 0
        uniq = np.unique(labels)
        remap = np.zeros(uniq.max() + 1, np.int32)
        remap[uniq] = np.arange(len(uniq))
        labels = remap[labels]
    return labels


# ---------------------------------------------------------------------------
# end-to-end inference


def _pad_to(x: np.ndarray, mult: int) -> tuple[np.ndarray, tuple[int, int]]:
    h, w = x.shape
    ph = -(-h // mult) * mult - h
    pw = -(-w // mult) * mult - w
    return np.pad(x, ((0, ph), (0, pw)), mode="reflect"), (h, w)


def flow_segment(
    image: np.ndarray,
    variables: dict,
    *,
    net: Optional[CPNet] = None,
    prob_threshold: float = 0.5,
    n_iter: int = 100,
    min_area: int = 30,
) -> np.ndarray:
    """Segment a 2D image with a trained ``CPNet``: predict flows +
    cell probability, follow flows, reconstruct the label mask."""
    net = net or CPNet()
    img = np.asarray(image, np.float32)
    lo, hi = np.percentile(img, [1.0, 99.0])
    img = np.clip((img - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    mult = 2 ** (len(net.mults) - 1)
    padded, (h, w) = _pad_to(img, mult)
    out = jax.jit(net.apply)(variables, jnp.asarray(padded)[None, ..., None])
    out = np.asarray(out[0, :h, :w, :])
    # the net predicts 5x flows (the training target's Cellpose-convention
    # scaling); the follower wants unit-magnitude steps
    flows = jnp.asarray(out[..., :2].transpose(2, 0, 1) / 5.0)
    prob = 1.0 / (1.0 + np.exp(-out[..., 2]))
    fg = prob > prob_threshold
    final = np.asarray(follow_flows(flows, jnp.asarray(fg), n_iter=n_iter))
    return flows_to_masks(final, fg, min_area=min_area)


# ---------------------------------------------------------------------------
# synthetic training (the zero-egress route to working weights)


def render_cell_batch(
    rng: np.random.Generator, *, batch: int = 4, size: int = 64,
    max_cells: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """(images, masks): soft-edged elliptical cells with touching pairs
    (nearest-center assignment makes contacts, the case thresholding
    cannot split) over Poisson background noise."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    images = np.zeros((batch, size, size), np.float32)
    masks = np.zeros((batch, size, size), np.int32)
    for b in range(batch):
        n = int(rng.integers(2, max_cells + 1))
        cy = rng.uniform(10, size - 10, n)
        cx = rng.uniform(10, size - 10, n)
        ry = rng.uniform(5, 9, n)
        rx = rng.uniform(5, 9, n)
        amp = rng.uniform(300, 900, n)
        # normalized distance to each cell; nearest-center assignment
        d = np.stack(
            [
                ((yy - cy[i]) / ry[i]) ** 2 + ((xx - cx[i]) / rx[i]) ** 2
                for i in range(n)
            ]
        )
        nearest = np.argmin(d, axis=0)
        inside = d[nearest, yy, xx] < 1.0
        masks[b][inside] = nearest[inside] + 1
        img = np.zeros((size, size), np.float64)
        for i in range(n):
            img += amp[i] * np.exp(-d[i] / 1.2)
        images[b] = rng.poisson(img + 20.0)
    return images, masks


def train_cpnet(
    *, steps: int = 300, seed: int = 0, size: int = 64, batch: int = 4,
    learning_rate: float = 1e-3, net: Optional[CPNet] = None, verbose: int = 0,
) -> dict:
    """Train a ``CPNet`` on synthetic cell renders: MSE on the center
    flows (weighted x5, Cellpose's convention) + BCE on the cell
    probability. Returns flax variables for ``flow_segment``."""
    import optax

    net = net or CPNet()
    rng = np.random.default_rng(seed)
    variables = init_cpnet(net, seed=seed, size=size)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, batch_stats, opt_state, x, flows_t, fg_t):
        def loss_fn(p):
            out, updates = net.apply(
                {"params": p, "batch_stats": batch_stats},
                x,
                mutable=["batch_stats"],
            )
            flow_mse = jnp.mean((out[..., :2] - 5.0 * flows_t) ** 2)
            bce = optax.sigmoid_binary_cross_entropy(out[..., 2], fg_t)
            return flow_mse + jnp.mean(bce), updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    for i in range(steps):
        images, masks = render_cell_batch(rng, batch=batch, size=size)
        lo = np.percentile(images, 1.0, axis=(1, 2), keepdims=True)
        hi = np.percentile(images, 99.0, axis=(1, 2), keepdims=True)
        x = np.clip((images - lo) / np.maximum(hi - lo, 1e-6), 0.0, 1.0)
        flows_t = np.stack([masks_to_flows(m) for m in masks])  # (B,2,H,W)
        params, batch_stats, opt_state, loss = step(
            params,
            batch_stats,
            opt_state,
            jnp.asarray(x)[..., None],
            jnp.asarray(flows_t.transpose(0, 2, 3, 1)),
            jnp.asarray((masks > 0).astype(np.float32)),
        )
        if verbose and (i % 25 == 0 or i == steps - 1):
            print(f"cpnet step {i}: loss {float(loss):.4f}")
    return {"params": params, "batch_stats": batch_stats}


def save_variables(variables: dict, path) -> None:
    import pickle

    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, variables), f)


def load_variables(path) -> dict:
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


# Weight-conversion note: the reference's production model is
# Cellpose-SAM (`cpsam_v2`), a SAM ViT backbone — there is no classic
# CPnet checkpoint contract to convert, so external masks stay the
# interop route for published models (`--mask-path`) and synthetic
# training is the native route to weights.  The torch→flax layout
# risks (OIHW→HWIO kernels, BatchNorm inference semantics, SAME
# padding) are pinned by `tests/test_ufish_torch_parity.py`, which
# exercises the same flax layer family this net is built from.
