from dgvit_tpu_torch.replay.buffer import (PrioritizedReplayBuffer,
                                           ReplayBuffer, reference_schema)
from dgvit_tpu_torch.replay.staging import BatchPrefetcher

__all__ = ["BatchPrefetcher", "PrioritizedReplayBuffer", "ReplayBuffer",
           "reference_schema"]
