"""Multi-device training and evaluation on ``torch.distributed``
(counterpart of ``pmpu_tpu/parallel``): the ranks and their ``data ×
model`` mesh, per-rank sharded data, the sharding rules and tensor
parallelism over the ``model`` axis (channel-sharded convs,
``parallel/tensor.py``), the data-parallel and host-local steps, and the
slice-parallel evaluator's gather and writer guard. As in the JAX package,
no CLI builds a mesh with ``model > 1``."""

from pmpu_tpu_torch.parallel.gather import gather_blocks, is_lead  # noqa: F401

from pmpu_tpu_torch.parallel.hostdata import (  # noqa: F401
    ShardedTripleBatcher,
    global_cube,
    host_volume_names,
    load_host_store,
    make_global_batch,
)
from pmpu_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_sharding,
    init_distributed,
    make_mesh,
    next_world_env,
    replicated,
    spawn_world,
)
from pmpu_tpu_torch.parallel.sharding import (  # noqa: F401
    StateShardings,
    gather_state,
    make_dp_train_step,
    make_hostlocal_dp_train_step,
    make_hostlocal_eval_step,
    make_param_shardings,
    make_state_shardings,
    param_spec,
    shard_state,
)
from pmpu_tpu_torch.parallel.tensor import tensor_parallel  # noqa: F401
