from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.core.mesh import MeshRuntime, make_mesh

__all__ = ["MeshRuntime", "make_mesh", "resolve_device"]
