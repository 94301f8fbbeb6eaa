"""Convolutional actor-critic for RGB observations (SB3 'CnnPolicy' shape).

The reference trains MlpPolicy only (examples/learn.py:72-75); this model is
the natural extension for ObservationType.RGB — a NatureCNN-style trunk
(32/64/64 channels) shared by separate policy/value heads, operating on the
(N, 48, 64, 4) ray-traced observations from ops/render.py.  Plain JAX:
`lax.conv_general_dilated` in NHWC with orthogonal (gain sqrt(2)) kernels.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gym_pybullet_drones_tpu.models.mlp import dense, dense_init, layer_key

_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # (features, kernel, stride)


@dataclasses.dataclass(frozen=True)
class ActorCriticCNN:
    """NatureCNN trunk + Gaussian policy / value heads.

    Input: (..., H, W, C) float32 in [0, 255] (scaled inside) — or the
    flattened equivalent, which is reshaped back using `image_shape`.
    init(key, obs) -> params; apply(params, obs) -> (mean, log_std, value).
    """

    action_dim: int
    image_shape: tuple = (48, 64, 4)
    hidden: int = 512

    def _images(self, obs):
        h, w, c = self.image_shape
        return obs.reshape(obs.shape[:-1] + (h, w, c)) \
            if obs.shape[-1] == h * w * c else obs

    @staticmethod
    def _conv(p, x, stride):
        y = jax.lax.conv_general_dilated(
            x, p["w"], (stride, stride), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + p["b"]

    def init(self, key, obs):
        ortho = jax.nn.initializers.orthogonal(np.sqrt(2))
        h, w, c_in = self.image_shape
        convs = []
        for i, (features, kernel, stride) in enumerate(_CONVS):
            convs.append({"w": ortho(layer_key(key, f"Conv_{i}"),
                                     (kernel, kernel, c_in, features),
                                     jnp.float32),
                          "b": jnp.zeros((features,), jnp.float32)})
            h, w, c_in = ((h - kernel) // stride + 1,
                          (w - kernel) // stride + 1, features)
        flat_dim = h * w * c_in
        return {"convs": convs,
                "trunk": dense_init(layer_key(key, "Dense_0"), flat_dim,
                                    self.hidden, np.sqrt(2)),
                "pi": dense_init(layer_key(key, "Dense_1"), self.hidden,
                                 self.action_dim, 0.01),
                "vf": dense_init(layer_key(key, "Dense_2"), self.hidden, 1,
                                 1.0),
                "log_std": jnp.zeros((self.action_dim,), jnp.float32)}

    def apply(self, params, obs):
        x = self._images(obs) / 255.0
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        for p, (_, _, stride) in zip(params["convs"], _CONVS):
            x = jax.nn.relu(self._conv(p, x, stride))
        x = x.reshape(lead + (-1,))
        trunk = jax.nn.relu(dense(params["trunk"], x))
        mean = dense(params["pi"], trunk)
        value = dense(params["vf"], trunk)
        return mean, params["log_std"], jnp.squeeze(value, axis=-1)
