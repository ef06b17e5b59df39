from consistencytta_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_train_state,
    sharded_eval,
    sharded_step,
    spawn,
)

__all__ = ["make_mesh", "shard_batch", "shard_train_state", "sharded_eval", "sharded_step",
           "spawn"]
