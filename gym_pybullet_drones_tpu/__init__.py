"""gym-pybullet-drones-tpu: a batched quadrotor environment suite in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of
gym-pybullet-drones (komxun routing fork): batched quadrotor physics,
embedded controllers, RL task environments, an on-device PPO learner, and
multi-device sharding — replacing the reference's PyBullet/C++ single-env
stack with jit/vmap-fused kernels over thousands of env instances.
"""
__version__ = "0.1.0"

from gym_pybullet_drones_tpu.params import CF2X, CF2P, RACE, get_params  # noqa: F401
from gym_pybullet_drones_tpu.utils.enums import (  # noqa: F401
    ActionType,
    DroneModel,
    ObservationType,
    Physics,
)

try:
    from gymnasium.envs.registration import register as _register
except ImportError:  # gymnasium is optional: no gym IDs without it
    _register = None

# Gymnasium IDs with parity to the reference registration
# (reference gym_pybullet_drones/__init__.py:3-21)
if _register is not None:
    for _id, _entry in [
        ("ctrl-aviary-v0", "gym_pybullet_drones_tpu.envs:CtrlAviary"),
        ("velocity-aviary-v0", "gym_pybullet_drones_tpu.envs:VelocityAviary"),
        ("hover-aviary-v0", "gym_pybullet_drones_tpu.envs:HoverAviary"),
        ("multihover-aviary-v0",
         "gym_pybullet_drones_tpu.envs:MultiHoverAviary"),
    ]:
        try:
            _register(id=_id, entry_point=_entry)
        except Exception:  # already registered (re-import)
            pass
