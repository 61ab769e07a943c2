from dgvit_tpu_torch.envs.base import Env, ResetResult, StepResult
from dgvit_tpu_torch.envs.kinematic import KinematicNavEnv

__all__ = ["Env", "KinematicNavEnv", "ResetResult", "StepResult"]
