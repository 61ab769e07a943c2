"""SimpleViT: the goal-free vision backbone of the reference's
vit_sac_network.py zoo.

Counterpart of `dgvit_tpu/models/simple_vit.py`:

  * patch embedding 'b c (h p1) (w p2) -> b h w (p1 p2 c)' and a Linear;
  * a fixed 2-D sin-cos positional embedding (`posemb_sincos_2d`, not a
    parameter), computed once in float64 and cast to the stream's dtype;
  * `depth` blocks: x + attention(LN(x)), then x + FeedForward(x), where
    the attention norms its own input, its q/k/v and output projections
    have no bias and the inner width heads x dim_head need not equal the
    model width; FeedForward is LN -> Linear -> GELU (the exact erf form,
    in every dtype) -> Linear;
  * the mean over the patches; `forward` returns the LayerNormed latent,
    `predict` the class head on a LayerNorm of its own.

Every attention goes through `ops.attention.dot_product_attention` with
the module's `attn_impl`: on the card `auto` takes the kernel K8 for more
than 128 patches (or a head wider than 128), `pallas` always; its
backward recomputes through K8's plain version.

Linears compute in the compute dtype (`layers.Linear`), norms in fp32,
as in the JAX module. With `capture` (the visualizer's attention maps,
JAX simple_vit.py:101-104) each block computes its softmax probabilities
(`attention_probs`), keeps them as its `captured` record (B, H, N, N)
and attends with them, never through K8. `seq_shard` (ring attention)
is not ported and raises by name.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgvit_tpu_torch.models.got import patchify_channels
from dgvit_tpu_torch.models.layers import ATTN_IMPLS, LayerNorm, Linear
from dgvit_tpu_torch.ops.attention import (attention_probs,
                                           dot_product_attention)


@functools.cache
def _posemb_f64(h: int, w: int, dim: int, temperature: float) -> np.ndarray:
    if dim % 4:
        raise ValueError("feature dimension must be multiple of 4 for "
                         "sincos emb")
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    omega = np.arange(dim // 4) / (dim // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    return np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)],
                          axis=1)


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """(h * w, dim) 2-D sin-cos embedding: omega = arange(dim / 4) /
    (dim / 4 - 1), 1 / temperature ** omega, the order [sin x, cos x,
    sin y, cos y]; float64, then cast to `dtype`."""
    pe = torch.from_numpy(_posemb_f64(h, w, dim, float(temperature)))
    return pe.to(device=device, dtype=dtype)


class SimpleBlock(nn.Module):
    """x + attn(LN(x)), then x + ff(x) with ff's own LayerNorm first."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 attn_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 capture: bool = False):
        super().__init__()
        g = generator
        inner = heads * dim_head
        self.heads, self.dim_head, self.attn_impl = heads, dim_head, attn_impl
        self.capture = bool(capture)
        self.captured: Optional[torch.Tensor] = None
        self.attn_norm = LayerNorm(dim)
        self.to_qkv = Linear(dim, 3 * inner, bias=False, dtype=dtype,
                             generator=g)
        self.to_out = Linear(inner, dim, bias=False, dtype=dtype,
                             generator=g)
        self.ff_norm = LayerNorm(dim)
        self.fc1 = Linear(dim, mlp_dim, dtype=dtype, generator=g)
        self.fc2 = Linear(mlp_dim, dim, dtype=dtype, generator=g)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if self.capture:
            probs = attention_probs(q, k, self.dim_head ** -0.5)
            self.captured = probs.detach()
            out = probs @ v
        else:
            out = dot_product_attention(q, k, v, self.dim_head ** -0.5,
                                        impl=self.attn_impl)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.attn_norm(x))
        h = F.gelu(self.fc1(self.ff_norm(x)))
        return x + self.fc2(h)


class SimpleViT(nn.Module):
    """(B, H, W) or (B, C, H, W) frames -> the (B, dim) latent (`forward`)
    or (B, num_classes) logits (`predict`). `head` False leaves out the
    class head, as the JAX policies' parameter trees do (they never call
    `predict`)."""

    def __init__(self, image_size: Tuple[int, int] = (128, 160),
                 patch_size: Tuple[int, int] = (16, 20),
                 num_classes: int = 2, dim: int = 256, depth: int = 2,
                 heads: int = 8, dim_head: int = 64, mlp_dim: int = 512,
                 channels: int = 1, attn_impl: str = "auto",
                 capture: bool = False, seq_shard: bool = False,
                 head: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r}")
        if seq_shard:
            raise NotImplementedError("seq_shard (ring attention) is not "
                                      "ported")
        g = generator
        self.image_size, self.patch_size = tuple(image_size), tuple(patch_size)
        self.dim = dim
        ph, pw = self.patch_size
        self.patch_embed = Linear(ph * pw * channels, dim, dtype=dtype,
                                  generator=g)
        self.transformer = nn.ModuleList(
            SimpleBlock(dim, heads, dim_head, mlp_dim, attn_impl, dtype, g,
                        capture=capture)
            for _ in range(depth))
        self.norm_out = LayerNorm(dim)
        if head:
            self.head_norm = LayerNorm(dim)
            self.head = Linear(dim, num_classes, dtype=dtype, generator=g)

    def trunk(self, img: torch.Tensor) -> torch.Tensor:
        """The mean over the patches of the last block's output, (B, dim)
        in the compute dtype."""
        ph, pw = self.patch_size
        if img.dim() == 3:
            img = img[:, None]
        h, w = img.shape[-2] // ph, img.shape[-1] // pw
        x = self.patch_embed(patchify_channels(img, ph, pw))
        x = x + posemb_sincos_2d(h, w, self.dim, dtype=x.dtype,
                                 device=x.device)
        for blk in self.transformer:
            x = blk(x)
        return x.mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.norm_out(self.trunk(img))

    def predict(self, img: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "head"):
            raise ValueError("this SimpleViT was built without its class "
                             "head (head=False)")
        return self.head(self.head_norm(self.trunk(img)))
