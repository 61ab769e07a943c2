from dgvit_tpu_torch.serve.export import make_action_fn
from dgvit_tpu_torch.serve.server import BatchingActorServer

__all__ = ["BatchingActorServer", "make_action_fn"]
