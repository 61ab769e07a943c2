from dgvit_tpu_torch.serve.export import make_action_fn
from dgvit_tpu_torch.serve.fleet import (FleetRunner, make_ros2_fleet,
                                         serve_fleet)
from dgvit_tpu_torch.serve.server import BatchingActorServer

__all__ = ["BatchingActorServer", "FleetRunner", "make_action_fn",
           "make_ros2_fleet", "serve_fleet"]
