"""Neural network models (plain JAX: init/apply on parameter pytrees)."""
from gym_pybullet_drones_tpu.models.mlp import (  # noqa: F401
    ActorCritic,
    gaussian_entropy,
    gaussian_log_prob,
)
from gym_pybullet_drones_tpu.models.cnn import ActorCriticCNN  # noqa: F401
