from dgvit_tpu_torch.ops.attention import dot_product_attention
from dgvit_tpu_torch.ops.cls_block import cls_final_block
from dgvit_tpu_torch.ops.fused_block import fused_attention_section
from dgvit_tpu_torch.ops.fused_preprocess import preprocess_depth_auto
from dgvit_tpu_torch.ops.fused_transformer import fused_transformer_block
from dgvit_tpu_torch.ops.got_megakernel import (blocks_cls_forward_fused,
                                                blocks_forward_plain,
                                                got_forward_fused,
                                                got_forward_plain)
from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_fused

__all__ = ["blocks_cls_forward_fused", "blocks_forward_plain",
           "cls_final_block", "dot_product_attention",
           "fused_attention_section", "fused_transformer_block",
           "got_forward_fused", "got_forward_plain", "load_kernels",
           "preprocess_depth_auto", "trunk_bwd_fused"]


def load_kernels() -> None:
    """Build every kernel library of the port at once (one nvcc each) and
    load each with its C signatures declared, so that threads which then
    launch kernels together never build one mid-run. Needs the CUDA
    toolkit."""
    from dgvit_tpu_torch.ops import (_build, attention, fused_preprocess,
                                     fused_transformer, got_megakernel)

    _build.build("got_megakernel", "block_grad", "attention",
                 "depth_preprocess")
    got_megakernel._kernel_lib()
    fused_transformer._block_lib()
    attention._attention_lib()
    fused_preprocess._kernel_lib()
