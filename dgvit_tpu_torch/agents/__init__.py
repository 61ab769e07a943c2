from dgvit_tpu_torch.agents.sac import SACAgent, SACState
from dgvit_tpu_torch.agents.teacher import SACTeacher

__all__ = ["SACAgent", "SACState", "SACTeacher"]
