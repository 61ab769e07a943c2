from dgvit_tpu_torch.ops.got_megakernel import (got_forward_fused,
                                                got_forward_plain)

__all__ = ["got_forward_fused", "got_forward_plain"]
