from dgvit_tpu_torch.agents.sac import SACAgent, SACState

__all__ = ["SACAgent", "SACState"]
