"""Multi-device parallelism: device meshes, env-batch sharding, collectives."""
from gym_pybullet_drones_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_sharded_update,
    shard_train_state,
)
from gym_pybullet_drones_tpu.parallel.distributed import (  # noqa: F401
    global_env_batch,
    initialize,
)
