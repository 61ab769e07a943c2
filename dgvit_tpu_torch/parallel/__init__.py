from dgvit_tpu_torch.parallel.shard import (shard_batch, shard_sac_state,
                                            sharded_learn, shardmap_learn)

__all__ = ["shard_batch", "shard_sac_state", "sharded_learn",
           "shardmap_learn"]
