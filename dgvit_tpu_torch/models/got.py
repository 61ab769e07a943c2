"""GoT: the goal-token vision transformer trunk.

Counterpart of `dgvit_tpu/models/got.py`. A (B, 128, 160) depth frame is
cut into 64 patches of 16x20 ('b (h p1) (w p2) -> b (h w) (p1 p2)'),
embedded to `dim`, the embedded goal is prepended as the CLS token, a
learned positional embedding is added, `depth` pre-norm blocks run, the
goal token is pooled and normed (RMS, or Layer for the frame-stack fork).

`forward` takes the JAX module's routes (got.py:102-118, 201-215). A
model whose blocks have no dropout, with `attn_impl` auto or fused, CLS
pooling and at most 256 tokens takes the fused routes, each a kernel
wrapper that runs the CUDA kernel on the card and its plain version on
the CPU, where the route's kernels hold a frame of that many tokens in a
thread block's shared memory (`ops/smem.py`; on the card only, and
decided from the shapes before any launch):

  * `inference` and `deterministic` on the full patch grid (acting,
    evaluation, serving): the whole trunk as one `got_forward_fused` call
    (K1). Casts match the JAX package's fused route: patches, goal,
    patch-embed kernel and bias, and the positional embedding go to the
    compute dtype; the final-norm parameters stay fp32;
  * `inference` with live dropout or a smaller image (the no-grad
    forwards of the SAC update): the embedding and emb-dropout in
    PyTorch, then `blocks_cls_forward_fused` (K4) on detached parameters;
  * gradient-bearing (`inference` False), by default: the embedding and
    emb-dropout, the differentiable per-block kernels (K2 for depth-1
    blocks, K3 for the CLS-only last block), then the final-norm module;
  * gradient-bearing with `trunk_grad` (the JAX package's opt-in switch
    `DGVIT_TRUNK_GRAD=1`, read where the networks are built): the
    embedding and emb-dropout, then K4 with parameter casts that keep the
    graph; its backward is the whole-trunk kernel K6.

Any other model or frame (block dropout, `attn_impl` xla or pallas, mean
pooling, `capture`, more than 256 tokens, a frame the route's kernels
cannot hold, blocks without an output projection: heads == 1 and
dim_head == dim) takes the composed route: the embedding, then each
block as `models/layers.py::TransformerBlock` composes it around the
attention kernels (K7, K8), the pooling and the final-norm module. With
`capture` each block keeps its softmax probabilities (`captured`, the
records `utils/visualizer.AttentionVisualizer` reads).

The embedding is the JAX composed path's: the patch-embed product rounded
to the compute dtype, then its bias, the goal token and the positional
embedding added in it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dgvit_tpu_torch.models import initializers as init
from dgvit_tpu_torch.models.layers import (ATTN_IMPLS, LayerNorm, Linear,
                                           RMSNorm, TransformerBlock)
from dgvit_tpu_torch.models.layers import dropout as flax_dropout
from dgvit_tpu_torch.ops.fused_block import MAX_TOKENS
from dgvit_tpu_torch.ops.got_megakernel import (blocks_cls_forward_fused,
                                                got_forward_fused)
from dgvit_tpu_torch.ops.smem import route_fits


def patchify_2d(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """'b (h p1) (w p2) -> b (h w) (p1 p2)' for (B, H, W) images."""
    b, hh, ww = img.shape
    h, w = hh // ph, ww // pw
    x = img.reshape(b, h, ph, w, pw).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h * w, ph * pw)


def patchify_channels(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """'b c (h p1) (w p2) -> b (h w) (p1 p2 c)' for (B, C, H, W) images."""
    b, c, hh, ww = img.shape
    h, w = hh // ph, ww // pw
    x = img.reshape(b, c, h, ph, w, pw).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h * w, ph * pw * c)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, attn_impl: str = "auto",
                 capture: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, heads, dim_head, mlp_dim, generator,
                             dropout=dropout, attn_impl=attn_impl,
                             capture=capture)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, cls_final: bool = False, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Every block in turn; with cls_final the last one returns the
        pooled CLS rows, (B, d)."""
        for i, blk in enumerate(self.blocks):
            x = blk(x, cls_only=cls_final and i == len(self.blocks) - 1,
                    deterministic=deterministic, generator=generator)
        return x


class GoT(nn.Module):
    def __init__(self, image_size: Tuple[int, int] = (128, 160),
                 patch_size: Tuple[int, int] = (16, 20), dim: int = 64,
                 depth: int = 4, heads: int = 4, dim_head: int = 64,
                 mlp_dim: int = 2048, channels: int = 1,
                 patch_mode: str = "2d", final_norm: str = "rms",
                 emb_dropout: float = 0.1, dropout: float = 0.0,
                 pool: str = "cls", attn_impl: str = "auto",
                 capture: bool = False, seq_shard: bool = False,
                 trunk_grad: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if patch_mode not in ("2d", "channels"):
            raise ValueError(patch_mode)
        if final_norm not in ("rms", "layer"):
            raise ValueError(final_norm)
        if pool not in ("cls", "mean"):
            raise ValueError(pool)
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r}")
        if seq_shard:
            raise NotImplementedError("seq_shard (ring attention) is not "
                                      "ported")
        self.pool, self.trunk_grad = pool, bool(trunk_grad)
        # the fused routes' static conditions (got.py:102-114) but capture;
        # the route rule (`route_fits`) refuses a block without an output
        # projection
        self._fused_ok = (attn_impl in ("auto", "fused") and dropout == 0.0
                          and pool == "cls")
        self.capture = bool(capture)
        self.image_size, self.patch_size = tuple(image_size), tuple(patch_size)
        self.heads, self.dim_head = heads, dim_head
        self.patch_mode, self.final_norm = patch_mode, final_norm
        self.compute_dtype = dtype
        self.emb_dropout = emb_dropout
        ph, pw = self.patch_size
        self.num_patches = (image_size[0] // ph) * (image_size[1] // pw)
        patch_dim = ph * pw * (channels if patch_mode == "channels" else 1)
        self.patch_embed = Linear(patch_dim, dim, generator=generator)
        self.pos_embedding = nn.Parameter(
            init.normal_(torch.empty(1, self.num_patches + 1, dim),
                         generator))
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       generator, dropout=dropout,
                                       attn_impl=attn_impl, capture=capture)
        self.norm_out = RMSNorm(dim) if final_norm == "rms" else LayerNorm(dim)
        self._cache_key = None
        self._cache = None

    @property
    def blocks_ok(self) -> bool:
        """Whether the fused routes may run: their static conditions, and
        no capture (`capture` may be switched on and off, as
        `utils/visualizer.AttentionVisualizer` does)."""
        return self._fused_ok and not self.capture

    def fused_params(self, cdt: torch.dtype):
        """(pe, pos, blocks, fn) as the no-grad kernels take them: detached
        casts, kept between calls until a parameter is replaced or changed
        in place."""
        params = list(self.parameters())
        key = (cdt, tuple((p.data_ptr(), p._version) for p in params))
        if key != self._cache_key:
            pe = (self.patch_embed.weight.detach().t().to(cdt).contiguous(),
                  self.patch_embed.bias.detach().to(cdt).contiguous())
            pos = self.pos_embedding.detach()[0].to(cdt).contiguous()
            blocks = [b.flat(cdt) for b in self.transformer.blocks]
            if self.final_norm == "rms":
                g = self.norm_out.g.detach().float().contiguous()
                fn = (g, torch.zeros_like(g))
            else:
                fn = (self.norm_out.weight.detach().float().contiguous(),
                      self.norm_out.bias.detach().float().contiguous())
            self._cache_key, self._cache = key, (pe, pos, blocks, fn)
        return self._cache

    def route_fits(self, kernels, n: int, cdt: torch.dtype,
                   device: torch.device) -> bool:
        """Whether every kernel of a fused route holds n-token frames of
        this trunk on `device` (`ops/smem.py`)."""
        blk = self.transformer.blocks[0]
        return route_fits(kernels, n, self.pos_embedding.shape[-1],
                          self.heads, self.dim_head, blk.w1.shape[1], cdt,
                          device)

    def _patches(self, img: torch.Tensor) -> torch.Tensor:
        ph, pw = self.patch_size
        return (patchify_2d(img, ph, pw) if self.patch_mode == "2d"
                else patchify_channels(img, ph, pw))

    def trunk_args(self, img: torch.Tensor, goal: torch.Tensor):
        """The arguments of `got_forward_fused` for these inputs."""
        if tuple(img.shape[-2:]) != self.image_size:
            raise ValueError(f"image {tuple(img.shape[-2:])}: the fused "
                             f"trunk takes the full grid {self.image_size}")
        cdt = self.compute_dtype or img.dtype
        pe, pos, blocks, fn = self.fused_params(cdt)
        return (self._patches(img).to(cdt).contiguous(),
                goal.to(cdt).contiguous(), pe, pos, blocks, fn, self.heads,
                self.dim_head, self.num_patches + 1, self.final_norm)

    def embed(self, img: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """(B, n + 1, dim) token stream in the compute dtype: patch
        embedding, goal token prepended, positional embedding added."""
        cdt = self.compute_dtype or img.dtype
        x = self.patch_embed(self._patches(img).to(cdt))
        x = torch.cat([goal[:, None, :].to(x.dtype), x], dim=1)
        return x + self.pos_embedding[:, :x.shape[1]].to(x.dtype)

    def forward(self, img: torch.Tensor, goal: torch.Tensor, *,
                deterministic: bool = True, inference: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """img (B, H, W) [2d] or (B, C, H, W) [channels]; goal (B, dim)
        embedded goal token. Returns the (B, dim) latent in the compute
        dtype. `deterministic` False applies emb-dropout and the blocks'
        dropout, the masks drawn from `generator`; `inference` selects the
        no-grad kernels."""
        ph, pw = self.patch_size
        in_patches = (img.shape[-2] // ph) * (img.shape[-1] // pw)
        acting = inference and deterministic \
            and in_patches == self.num_patches
        blocks_ok = (self.blocks_ok and in_patches + 1 <= MAX_TOKENS
                     and (inference or self.trunk_grad)
                     and self.route_fits(
                         ("K1",) if acting else ("K4",) if inference
                         else ("K4", "K6"), in_patches + 1,
                         self.compute_dtype or img.dtype, img.device))
        if blocks_ok and acting:
            return got_forward_fused(*self.trunk_args(img, goal))
        x = self.embed(img, goal)
        if not deterministic:
            x = flax_dropout(x, self.emb_dropout, generator)
        if blocks_ok:
            if inference:
                _, _, blocks, fn = self.fused_params(x.dtype)
            else:       # casts that keep the graph; the final norm in fp32
                blocks = [tuple(getattr(b, n).to(x.dtype) for n in b.ORDER)
                          for b in self.transformer.blocks]
                fn = ((self.norm_out.g, torch.zeros_like(self.norm_out.g))
                      if self.final_norm == "rms" else
                      (self.norm_out.weight, self.norm_out.bias))
            return blocks_cls_forward_fused(x.contiguous(), blocks, fn,
                                            self.heads, self.dim_head,
                                            self.final_norm)
        x = self.transformer(x, cls_final=self.pool == "cls",
                             deterministic=deterministic,
                             generator=generator)
        if self.pool == "mean":
            x = x.mean(dim=1)
        return self.norm_out(x)
