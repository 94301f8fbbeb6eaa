"""Actor-critic MLP policy (SB3 'MlpPolicy' semantics) in plain JAX.

The reference delegates its learner to stable-baselines3 PPO with the default
MlpPolicy (reference examples/learn.py:72-75): separate pi/vf towers of
[64, 64] tanh units, a state-independent log-std Gaussian head initialized at
0, and orthogonal initialization (gain sqrt(2) hidden, 0.01 policy head, 1.0
value head).  This module reproduces that architecture as pure functions on
a parameter pytree, so the policy fuses into the jitted rollout/training
program.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def layer_key(key, name: str):
    """The init key of layer `name` ("Dense_0", "Conv_1", ...) as Flax linen
    derives it: the first 4 bytes of SHA-1(name, counter 1) folded into the
    model key.  Keeps the parameters equal to those of the Flax modules this
    package used before, bit for bit, for the same key."""
    digest = hashlib.sha1(name.encode() + b"\x01").digest()
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(digest[:4], "big")))


def dense_init(key, n_in: int, n_out: int, gain: float):
    """Orthogonal (gain) kernel (n_in, n_out) and zero bias."""
    w = jax.nn.initializers.orthogonal(gain)(key, (n_in, n_out), jnp.float32)
    return {"w": w, "b": jnp.zeros((n_out,), jnp.float32)}


def dense(p, x, dtype=None):
    """x @ w + b, computed in `dtype` when given (params stay float32)."""
    w, b = p["w"], p["b"]
    if dtype is not None:
        x, w, b = x.astype(dtype), w.astype(dtype), b.astype(dtype)
    return x @ w + b


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Separate-tower actor-critic with diagonal-Gaussian policy head.

    init(key, obs) -> params; apply(params, obs) -> (mean, log_std, value).
    """

    action_dim: int
    hidden: Sequence[int] = (64, 64)
    log_std_init: float = 0.0
    # computation dtype for the dense layers (params stay float32 master
    # weights, cast per layer); outputs are cast back to float32 for the loss
    compute_dtype: object = None

    def init(self, key, obs):
        widths = (obs.shape[-1],) + tuple(self.hidden)
        # layers per tower, named Dense_0.. as Flax numbered them: pi, vf
        depth = len(self.hidden) + 1

        def tower(first, out_dim, head_gain):
            gains = [np.sqrt(2)] * len(self.hidden) + [head_gain]
            outs = widths[1:] + (out_dim,)
            return [dense_init(layer_key(key, f"Dense_{first + i}"),
                               widths[i], outs[i], gains[i])
                    for i in range(depth)]

        return {"pi": tower(0, self.action_dim, 0.01),
                "vf": tower(depth, 1, 1.0),
                "log_std": jnp.full((self.action_dim,), self.log_std_init,
                                    jnp.float32)}

    def apply(self, params, obs):
        cd = self.compute_dtype

        def tower(layers):
            x = obs
            for p in layers[:-1]:
                x = jnp.tanh(dense(p, x, cd))
            return dense(layers[-1], x, cd).astype(jnp.float32)

        mean = tower(params["pi"])
        value = tower(params["vf"])
        return mean, params["log_std"], jnp.squeeze(value, axis=-1)


def gaussian_log_prob(mean, log_std, action):
    """Diagonal-Gaussian log pdf summed over the action dimension."""
    var = jnp.exp(2 * log_std)
    return jnp.sum(
        -0.5 * ((action - mean) ** 2 / var + 2 * log_std
                + jnp.log(2 * jnp.pi)), axis=-1)


def gaussian_entropy(log_std):
    """Entropy of the diagonal Gaussian (state-independent)."""
    return jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e), axis=-1)
