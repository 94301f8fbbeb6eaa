"""Environments: functional core, task layer, Gymnasium adapters.

The Gymnasium adapters (BatchedEnv, the *Aviary classes) need the optional
`gymnasium` package; they are imported on first access, so the functional
core, the tasks and the trainer import without it.
"""
import importlib

from gym_pybullet_drones_tpu.envs.core import (  # noqa: F401
    AviaryConfig,
    EnvState,
    adjacency_matrix,
    next_waypoint,
    reset,
    state_vector,
    step,
    step_autoreset,
)
from gym_pybullet_drones_tpu.envs.tasks import (  # noqa: F401
    CtrlTask,
    HoverTask,
    MultiHoverTask,
    RLTask,
    VelocityTask,
)
from gym_pybullet_drones_tpu.envs.routing import RoutingTask, make_routing_config  # noqa: F401

_ADAPTERS = {
    "BatchedEnv": "gym_adapter",
    "CtrlAviary": "gym_adapter",
    "FunctionalAviary": "gym_adapter",
    "HoverAviary": "gym_adapter",
    "MultiHoverAviary": "gym_adapter",
    "VelocityAviary": "gym_adapter",
    "CFAviary": "cf_aviary",
    "BetaAviary": "beta_aviary",
}


def __getattr__(name):
    if name in _ADAPTERS:
        module = importlib.import_module(f"{__name__}.{_ADAPTERS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
