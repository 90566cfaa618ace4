"""The U-FISH U-Net as a Flax module, for training.

Inference does not need Flax: :class:`~.ufish.UFishPredictor` runs the same
variables through plain ``lax`` convolutions. This module holds the
trainable definition (`models/ufish_train.py`) and the layout the
variables follow (``ConvBlock_i/Conv_j``, ``BatchNorm_j``, the decoder's
``Conv_k`` or ``ConvTranspose_k``).
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp


class ConvBlock(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        x = nn.relu(x)
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        x = nn.relu(x)
        return x


class UFishNet(nn.Module):
    """2D U-Net (U-FISH ``c32`` family: base 32, two downsamplings).

    ``up_mode`` selects the decoder upsampling:

    - ``"convtranspose"`` — ``ConvTranspose(2×2, stride 2)``, the textbook
      U-Net decoder and the assumed topology of the published U-FISH
      checkpoints (`models/ufish_topology.json`),
    - ``"resize"`` — nearest-neighbour resize + Conv(2×2) (the r1/r2
      architecture, kept for existing converted/pickled params).

    The ONNX converter (`ufish_onnx.infer_topology`) distinguishes the two
    from the checkpoint's weight shapes, so either family converts without
    the caller knowing which was exported.
    """

    base_features: int = 32
    depths: Sequence[int] = (1, 2, 4)
    up_mode: str = "resize"

    @nn.compact
    def __call__(self, x):  # x: (B, H, W, 1)
        skips = []
        f = [self.base_features * d for d in self.depths]
        for feats in f[:-1]:
            x = ConvBlock(feats)(x)
            skips.append(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = ConvBlock(f[-1])(x)
        for feats, skip in zip(reversed(f[:-1]), reversed(skips)):
            if self.up_mode == "convtranspose":
                x = nn.ConvTranspose(feats, (2, 2), strides=(2, 2))(x)
            else:
                b, h, w, c = x.shape
                x = jax.image.resize(x, (b, h * 2, w * 2, c), method="nearest")
                x = nn.Conv(feats, (2, 2), padding="SAME")(x)
            x = jnp.concatenate([x, skip], axis=-1)
            x = ConvBlock(feats)(x)
        x = nn.Conv(1, (1, 1))(x)
        return nn.sigmoid(x)
