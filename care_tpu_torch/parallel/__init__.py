from care_tpu_torch.parallel.mesh import (
    make_mesh, parse_mesh, shard_batch, shard_params, param_pspec, Mesh,
    DATA_AXIS, MODEL_AXIS)
from care_tpu_torch.parallel.input import (
    process_slice, global_batch_from_local, HostShardedBatches)

__all__ = ["make_mesh", "parse_mesh", "shard_batch", "shard_params",
           "param_pspec", "Mesh", "DATA_AXIS", "MODEL_AXIS", "process_slice",
           "global_batch_from_local", "HostShardedBatches"]
