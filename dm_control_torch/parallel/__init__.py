"""Process-level parallelism on ``torch.distributed``.

Counterpart of ``dm_control_tpu/parallel``: one process a device, joined
in a process group (NCCL on the card, gloo on the CPU); the env batch
split along its leading axis, each rank holding and stepping its own rows
with no collective inside the step; the learner state replicated, with
its inputs gathered or its gradients reduced over the group.
"""

from dm_control_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather_rows, all_reduce_mean, env_sharding, make_mesh,
    replicated, shard_batch, shard_env_map,
)
from dm_control_torch.parallel.runtime import (  # noqa: F401
    assert_partitioned, env_batch_sharding, initialize,
    make_global_env_batch, pod_mesh,
)
