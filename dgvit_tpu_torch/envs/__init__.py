from dgvit_tpu_torch.envs.base import Env, ResetResult, StepResult
from dgvit_tpu_torch.envs.kinematic import KinematicNavEnv
from dgvit_tpu_torch.envs.replay_env import ReplayEnv

__all__ = ["Env", "KinematicNavEnv", "ReplayEnv", "ResetResult",
           "StepResult"]
