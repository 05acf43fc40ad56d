"""Multi-device training and evaluation on ``torch.distributed``
(counterpart of ``pmpu_tpu/parallel``): the ranks and their mesh, per-rank
sharded data, the data-parallel and host-local steps, and the slice-parallel
evaluator's gather and writer guard. Tensor parallelism over the ``model``
axis is not ported (``make_mesh(model > 1)`` raises)."""

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
    make_dp_train_step,
    make_hostlocal_dp_train_step,
    make_hostlocal_eval_step,
)
