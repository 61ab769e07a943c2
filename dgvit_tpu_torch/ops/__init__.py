from dgvit_tpu_torch.ops.cls_block import cls_final_block
from dgvit_tpu_torch.ops.fused_preprocess import preprocess_depth_auto
from dgvit_tpu_torch.ops.fused_transformer import fused_transformer_block
from dgvit_tpu_torch.ops.got_megakernel import (blocks_cls_forward_fused,
                                                blocks_forward_plain,
                                                got_forward_fused,
                                                got_forward_plain)

__all__ = ["blocks_cls_forward_fused", "blocks_forward_plain",
           "cls_final_block", "fused_transformer_block", "got_forward_fused",
           "got_forward_plain", "preprocess_depth_auto"]
