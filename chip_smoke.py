#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dgvit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card, nvcc and
nothing built: it builds the kernels itself (into build/kernels/, one nvcc
per source, all at once), then

  1. device: prints the card's name and power limit (nvidia-smi), and
     the CUDA kernels behind K5's wrapper (torch.profiler);
  2. K1 against its plain version: the whole-trunk kernel
     (got_forward_fused) and got_forward_plain on the same inputs, with
     the trained flagship actor's weights
     (artifacts/r5/dr_randm32_s11_amin_actor.npz), bf16 at
     B in {1, 3, 8, 32, 64, 2048} and fp32 at B in {1, 8}; on the same
     bf16 batches two wrong versions of the trunk (erf GELU, residual
     kept in fp32 across blocks) must FAIL the same checks, which shows
     that the bf16 limits see the faults only the bf16 build can have;
  3. policy through the kernel: make_action_fn on the card serves the 16
     golden frames; actions held against the plain path on the card and
     against the JAX package's fp32 actions (tests/data/
     torch_port_golden.npz);
  4. serving, the first main path: a BatchingActorServer (buckets
     1/8/16/32) answers 32 client threads x 4 requests; every answer
     equals the direct act for that row, and K1's launch count rose;
  5. the training kernels against their plain versions (K4, K2 forward
     and backward, K3 forward and backward): the trained actor's and a
     seeded critic's blocks on embedded streams of seeded frames, bf16 at
     B in {1, 32, 256} and fp32 at B in {1, 8}; outputs, dx and all 11
     weight gradients; wrong bf16 versions must FAIL the same bf16
     limits: for K2b and K3b autograd of the plain forward (which rounds
     at other points than the hand-placed ones), for K3b also k and v of
     the recompute left in fp32 (its tensor-core projection's outputs),
     for K4 an erf GELU and the residual kept in fp32 across blocks, for
     K2f the probabilities left in fp32 before P.V;
 5b. the bf16 forward and backward off the flagship widths (81 tokens,
     2 x 32 heads, an unaligned x) take the FMA bodies, not the
     tensor-core ones, and K2f, K2b and K3b there meet the bf16 limits of
     5, K6 those of 13, K4 phase 5's per-tensor max and phase 13's
     per-frame rule; K6 with only its CLS block's w1 unaligned takes the
     FMA bodies and meets phase 13's limits;
 5c. the weight products of the backwards (wgrad_mma_kernel on the
     tensor cores in bf16, wgrad_kernel else) against wgrad_plain, which
     sums the kernels' row segments in their order (its wgrad_splits
     equal to the library's segment counts): the default update's shapes
     at B=256, K3b's CLS operands and awkward ones (rows not a multiple
     of the chunk, K and N not multiples of 64, K not a multiple of 8, an
     unaligned A), bf16 and fp32; the update's six at B=256 timed on the
     tensor cores beside the FMA kernel and beside `a.t() @ b` (cuBLAS),
     by CUDA events and by device time;
  6. the SAC update, the second main path: a bf16 SACAgent (batch 256,
     emb-dropout 0.1) takes 5 learn steps on a seeded replay batch with
     finite losses, each step launching exactly K4 x3, K2f x6, K2b x6,
     K3f x2 and K3b x2 (and no K6, K7 or K8); then one fp32 update
     through the kernels matches
     the same update through the plain versions on the card and the JAX
     golden update (tests/data/torch_sac_golden.npz);
  7. profile: one more bf16 update under torch.profiler, device time by
     CUDA kernel, in all and per call, the weight products' total, the
     device's busy share of the update, and its CUDA launches by kernel
     name held to the design (K4, K2f, K2b, K3b and the weight products
     on the tensor-core kernels at the flagship widths);
  8. times: K1 and its plain version at B in {1, 32, 64, 2048}, and the
     training kernels at B=256 (median of CUDA-event timings), beside
     their bounds, the kernels redesigned for the tensor cores (K2b, K4,
     K2f, K3b) also beside their earlier designs' times, K2b and K3b also
     by device time split into the per-frame pass and the weight
     products, and K4 by depth;
  9. K5 against its plain version: the fused depth ingest
     (preprocess_depth_fused) and preprocess_depth_plain on raw 512x640
     frames at B in {1, 3, 32, 256}, sigma 0 and 50: uniform frames,
     frames rendered by the port's kinematic env, a constant frame and
     one of extreme range; two wrong chains (the band blur reflected at
     the image's edges instead of the band's own; round instead of floor
     in the normalisation) must FAIL the same limit; the noise's mean and
     spread against the chain with torch.randn noise, determinism for a
     seed, difference between seeds, frame-alone = frame-in-batch;
 10. camera to action, the third main path: 32 raw frames ->
     preprocess_depth_auto (K5) -> make_action_fn with the trained actor
     (K1) -> velocity commands, held against the plain path on the card,
     with K5 and K1 launched exactly once each;
 11. train and evaluate, the fourth main path: train_rl.train at the
     flagship width (bf16, batch 256) on the kinematic RRC env until
     about 100 updates have run; every update launches exactly K4 x3,
     K2f x6, K2b x6, K3f x2, K3b x2 and every action K1 x1; finite
     metrics; a checkpoint is written, `resume` restores it and the next
     update equals the one taken without the restart; the saved actor
     reloads through load_params_npz -> params_from_jax and gives the
     same actions; the same run again with sac.prefetch_batches, held to
     the same launch counts; then run_eval for 3 episodes; env steps/s,
     updates/s and the split of the loop into env, act, sample+copy and
     learn, for both runs;
 12. times of K5 and its plain version at B in {1, 32, 256} beside its
     bound;
 13. K6 against its plain version (trunk_bwd_fused, trunk_bwd_plain): the
     trained actor's trunk with its RMS norm and the seeded critic's with
     a Layer norm, bf16 and fp32 at B in {1, 3, 8, 256}, 65 tokens and
     17; dx, the 44 block gradients and the final norm's; two wrong
     backwards (autograd of the plain forward; a chain that hands dx on
     in fp32) must FAIL the bf16 limits; and K6 (its CLS block on the
     tensor-core body of K3b) against the K3b + K2b chain of per-block
     kernels on the same inputs;
 14. the trunk-gradient update, the fifth main path: with
     DGVIT_TRUNK_GRAD=1 a bf16 SACAgent takes 5 learn steps at B=256, each
     launching exactly K4 x5 and K6 x2 and no per-block kernel; one fp32
     update on that route matches the plain versions on the card and the
     default-route update from the same state; a profiled update's CUDA
     launches are those designed; ms per update beside the default
     route's;
 15. K7 and K8 against their plain versions (fused_attention_section at
     (256, 65, 64) and 256 tokens; attention_fused at (256, 4, 65, 64),
     (64, 4, 257, 64) and D = 160), bf16 and fp32, forward and backward;
     versions that leave padded keys unmasked or mis-scale must FAIL;
 16. the composed routes through the model, main paths: the flagship
     actor with GoT(dropout=0.1), a training forward and backward at
     B=256 (K7 x4); build_actor(cfg, attn_impl="pallas"), an acting
     forward at B=256 (K8 x4, K1 x0), its actions against the K1 route's;
     model.patch_size (8, 10), 257 tokens, at B=64 (K8 x4 by `auto`);
 17. times of K6, K7, K8 and their plain versions beside their bounds,
     K6 and K8 (redesigned for the tensor cores) also beside their
     earlier design's times, and torch's scaled_dot_product_attention
     beside K8, both also by device time (torch.profiler);
 17b. long frames: every byte count of ops/smem.py against the
     libraries' own queries (the tensor-core backward bodies' too); then
     frames of 90, 129 and 256 tokens (past the 80 rows of the
     tensor-core bodies: the FMA bodies), fp32
     and bf16, through acting, the learn forward, the gradient route and
     the trunk-gradient route of the trained actor's trunk, each call on
     the route the shared-memory rule picks (fused where the route's
     kernels hold the frame, else composed), with exactly that route's
     launches, its latent and gradients against the plain version of the
     same route; and, at 129 bf16 tokens, the composed gradient route's
     distance from the fused plain chain (a record);

then prints one JSON line describing each kernel and, last, the device
line {"ok": true, "device": {...}}. Any failed check raises and ends the
run with a non-zero exit, before the last line. TF32 is switched off for
matmuls and cuDNN, so fp32 products of the plain version are full fp32.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ACTOR = ROOT / "artifacts" / "r5" / "dr_randm32_s11_amin_actor.npz"
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
GOLDEN_SEED, GOLDEN_FRAMES = 2026, 16
SEED = 7
DEVICE = "cuda"
CHECK_BATCHES = {"bfloat16": (1, 3, 8, 32, 64, 2048), "float32": (1, 8)}
TIMED_BATCHES = ((1, 50), (32, 20), (64, 10), (2048, 2))   # (batch, reps)
# the SAC slice: kernel checks, the update's main path, its golden file
TRAIN_BATCHES = {"bfloat16": (1, 32, 256), "float32": (1, 8)}
SAC_BATCH, SAC_STEPS = 256, 5
PER_UPDATE = {"K1": 0, "K4": 3, "K2f": 6, "K2b": 6, "K3f": 2, "K3b": 2,
              "K5": 0, "K6": 0, "K7": 0, "K8": 0}
# with DGVIT_TRUNK_GRAD=1: the two gradient forwards join K4, K6 is their
# backward, and the per-block kernels rest
PER_UPDATE_TRUNK = {**{k: 0 for k in PER_UPDATE}, "K4": 5, "K6": 2}
GOLDEN_SAC = ROOT / "tests" / "data" / "torch_sac_golden.npz"
GOLDEN_SAC_SEED, GOLDEN_SAC_BATCH, CRITIC_SEED = 11, 8, 5

# the ingest slice: K5's checks, the camera-to-action path, the trainer
K5_BATCHES, K5_SIGMAS = (1, 3, 32, 256), (0.0, 50.0)
K5_TIMED = ((1, 20), (32, 10), (256, 3))                   # (batch, reps)
K5_PROFILED = 20           # calls in the window that names K5's CUDA kernels
CAMERA_FRAMES, CAMERA_SEED = 32, 2024
TRAIN_EPISODES, TRAIN_MAX_STEPS, TRAIN_BUFFER = 11, 52, 4096
EVAL_EPISODES, EVAL_MAX_STEPS = 3, 100
# K5 against its plain version. Both take every product and sum in fp32,
# each rounded on its own and in the same order (the kernel through
# __fmul_rn / __fadd_rn, the plain chain one PyTorch operation at a time),
# and draw the same noise bits, so an H100 read max |err| = 0 on states in
# [0, 1] at sigma 0 and 50 alike. The limit leaves a few fp32 roundings
# (2^-20, about 8 ulps at 0.5); one u8 step of one input pixel moves a
# state by up to 3.8e-4 and the wrong chains by more, so both fail it.
K5_MAX = 2.0 ** -20
K5_NOISE_STATS = 0.01      # mean and std of the states, as the JAX test

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version on the same card.
# fp32: both accumulate in fp32 in another order; 1e-4 abs + rel.
# bf16: both round to bf16 at the same points, so most latents agree bit
# for bit, but another summation order can flip one bf16 rounding and the
# flip propagates. Errors are taken relative to the largest |latent| L
# (~0.37-0.47). Each batch: max <= 2^-7 L (one bf16 ulp at the top of the
# range; an H100 read 1.95e-3 = 2^-9 at B=2048). All bf16 batches pooled
# (139k latents, most from B=2048): mean <= 2^-17 L (an H100 read
# 1.3e-6 at B=2048). The mean is pooled because a single flip in a batch
# of one moves that batch's mean by ~3e-5. With the trained weights an
# erf GELU changes few bf16 roundings (mean ~7e-6 on the CPU at B=64-256,
# nothing at B=1), so the pooled mean is what separates it; phase 2 shows
# that both wrong trunks fail these limits.
F32_TOL = 1e-4
BF16_MAX, BF16_MEAN = 2.0 ** -7, 2.0 ** -17
# Actions (|a| < 1, bf16 ulp 2^-8 on [0.5, 1)): the bf16 kernel path
# against the bf16 plain path on the card within two ulps of the action
# (the trunk's rare flips pass through the bf16 heads; an H100 read
# 2^-8); the bf16 policy against the JAX fp32 golden actions differs by
# the bf16 model error itself (1.1e-2 on an H100, 1.4e-2 on the CPU for
# these frames).
ACTION_BF16 = 2.0 ** -7
ACTION_BF16_VS_FP32 = 2.0 ** -5
ACTION_FP32 = 1e-4


def check(ok, what: str) -> None:
    """A failed check ends the run (explicit, so `python -O` keeps it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def golden_inputs(seed=GOLDEN_SEED, frames=GOLDEN_FRAMES):
    """Depth frames in [0, 1] and polar goals, as tests/test_torch_policy.py
    draws them for the golden file."""
    import numpy as np

    rng = np.random.default_rng(seed)
    obs = rng.uniform(0, 1, (frames, 128, 160)).astype(np.float32)
    goal = np.stack([rng.uniform(0, 1, frames), rng.uniform(-1, 1, frames)],
                    axis=1).astype(np.float32)
    return obs, goal


def k1_work(cfg, batch: int, dtype: str):
    """FLOPs and bytes K1 needs for `batch` frames: 65 tokens (no padded
    rows), k/v for every row and q/attention/MLP for the CLS row in the
    last block; every input read once, the output written once."""
    m = cfg.model
    ph, pw = m.patch_size
    n_patch = (m.image_size[0] // ph) * (m.image_size[1] // pw)
    n, pd, d = n_patch + 1, ph * pw, m.latent_size
    inner, mlp, depth = m.head * m.dim_head, m.mlp_dim, m.block
    full = (2 * n * d * 3 * inner + 4 * m.head * n * n * m.dim_head
            + 2 * n * inner * d + 4 * n * d * mlp)
    cls = (2 * n * d * 2 * inner + 2 * d * inner + 4 * m.head * n * m.dim_head
           + 2 * inner * d + 4 * d * mlp)
    flops = batch * (2 * n_patch * pd * d + (depth - 1) * full + cls)
    esize = 2 if dtype == "bfloat16" else 4
    weights = (pd * d + d + n * d
               + depth * (3 * inner * d + inner * d + mlp * d * 2 + mlp + 6 * d))
    bytes_ = (batch * (n_patch * pd + 2 * d) + weights) * esize + 2 * d * 4
    return flops, bytes_


def bound_ms(flops, bytes_, dtype):
    """The least time of the work on an H100: the larger of its operations
    over the peak rate of their type and its bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cuda_ms(fn, reps: int, runs: int = 7) -> float:
    """Median over `runs` of the mean time of `reps` back-to-back calls,
    from CUDA events, after a warm-up call. Weights stay in L2 between
    calls, as they do in a serving loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_kernels_ms(fn, calls: int = 50, tries: int = 3):
    """The device time of one call of `fn` by CUDA kernel name ({name: ms
    a call}, from torch.profiler over `calls` calls after a warm-up). A
    window in which the profiler recorded nothing is taken again with four
    times the calls; after `tries` empty windows it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.device_time_total / calls / 1e3
              for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.device_time_total > 0}
        if by:
            return by
        calls *= 4
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                       "windows")


def device_ms(fn, calls: int = 50, tries: int = 3):
    """The device time of one call of `fn`, its CUDA kernels summed
    (device_kernels_ms). Beside cuda_ms for the small kernels, whose
    back-to-back calls can wait on the host."""
    return sum(device_kernels_ms(fn, calls, tries).values())


def trunk_inputs(policy, batch, rng):
    """got_forward_fused's arguments for `batch` seeded frames, as GoT
    hands them to the trunk."""
    import torch

    dev = torch.device(DEVICE)
    img = torch.from_numpy(rng.uniform(0, 1, (batch, 128, 160))
                           .astype("float32")).to(dev)
    goal = torch.from_numpy(rng.uniform(-1, 1, (batch, 2))
                            .astype("float32")).to(dev)
    with torch.no_grad():
        return policy.trans.trunk_args(img, policy.fc_embed(goal))


@contextlib.contextmanager
def erf_gelu():
    """The plain versions with an erf GELU where the TPU kernel uses the
    tanh form (a wrong bf16 rounding point's worth of difference)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    tanh_gelu = ft._gelu32
    ft._gelu32 = lambda x, cdt: 0.5 * x * (1.0 + torch.erf(
        x * ft._INV_SQRT2))
    try:
        yield
    finally:
        ft._gelu32 = tanh_gelu


def trunk_erf_gelu(*args):
    """A wrong bf16 trunk: the plain version with an erf GELU where the
    TPU kernel uses the tanh form."""
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain

    with erf_gelu():
        return got_forward_plain(*args)


def k4_erf_gelu(*args):
    """A wrong bf16 K4: its plain version with an erf GELU."""
    from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain

    with erf_gelu():
        return blocks_forward_plain(*args)


def k4_f32_residual(x, blocks, fn, heads, dim_head, final_norm):
    """A wrong bf16 K4: its plain version with the residual stream kept in
    fp32 across blocks (no rounding after each block)."""
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.cls_block import cls_block_plain

    x32 = x.float()
    for w in blocks[:-1]:
        x32 = ft.block_plain(x32, w, heads=heads, dim_head=dim_head,
                             cdt=x.dtype)
    cls = cls_block_plain(x32, blocks[-1], heads=heads, dim_head=dim_head,
                          cdt=x.dtype)
    return gm._final_norm32(cls, *fn, final_norm).to(x.dtype)


def k2f_f32_probs(x, w, heads, dim_head):
    """A wrong bf16 K2f: its plain version with the attention
    probabilities left in fp32 before P.V (the TPU kernel rounds them to
    the compute dtype)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    rounded = ft._attention
    ft._attention = lambda q, k, v, heads, dim_head, cdt: rounded(
        q, k, v, heads, dim_head, torch.float32).to(cdt)
    try:
        return ft.block_fwd_plain(x, w, heads, dim_head)
    finally:
        ft._attention = rounded


def k3b_f32_kv(x, dy, w, heads, dim_head):
    """A wrong bf16 K3b: its plain version with the recomputed k and v of
    every row left in fp32 (the TPU kernel rounds them to the compute
    dtype: the outputs of the tensor-core body's projection)."""
    from dgvit_tpu_torch.ops import cls_block as cb

    rounded = cb._kv_rows
    cb._kv_rows = lambda h1, wkv, cdt: cb._mm(h1, wkv)
    try:
        return cb.cls_bwd_plain(x, dy, w, heads, dim_head)
    finally:
        cb._kv_rows = rounded


def trunk_f32_residual(patches, goal, pe, pos, blocks, fn, heads, dim_head,
                       n_valid, final_norm):
    """A wrong bf16 trunk: the plain version with the residual stream kept
    in fp32 across blocks (no rounding after each block)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.cls_block import cls_block_plain

    cdt = patches.dtype
    emb = (ft._mm(patches, pe[0]) + pe[1].float()).to(cdt)
    x = torch.cat([goal[:, None, :], emb], dim=1)
    x32 = (x.float() + pos.float()[None]).to(cdt).float()
    for w in blocks[:-1]:
        x32 = ft.block_plain(x32, w, heads=heads, dim_head=dim_head, cdt=cdt)
    cls = cls_block_plain(x32, blocks[-1], heads=heads, dim_head=dim_head,
                          cdt=cdt)
    return gm._final_norm32(cls, *fn, final_norm).to(cdt)


class Bf16Errors:
    """|err| of one bf16 trunk against the plain version over the bf16
    batches: each batch's max against 2^-7 L, the pooled mean against
    2^-17 L (L the largest |latent| seen)."""

    def __init__(self):
        self.sum = self.count = self.scale = 0.0
        self.max_ok = True

    def add(self, out, ref):
        err = (out.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        self.sum += err.sum().item()
        self.count += err.numel()
        self.scale = max(self.scale, scale)
        self.max_ok &= err.max().item() <= BF16_MAX * scale
        return err.max().item(), err.mean().item(), scale

    @property
    def mean(self):
        return self.sum / self.count

    @property
    def ok(self):
        return self.max_ok and self.mean <= BF16_MEAN * self.scale


def phase_kernel_vs_plain(cfg, policies, rng):
    import torch

    from dgvit_tpu_torch.ops.got_megakernel import (got_forward_fused,
                                                    got_forward_plain)

    worst = {}
    wrongs = {"erf GELU": trunk_erf_gelu,
              "fp32 residual": trunk_f32_residual}
    errs = {name: Bf16Errors() for name in ("K1", *wrongs)}
    cases = [(dt, b) for dt, bs in CHECK_BATCHES.items() for b in bs]
    for dtype, batch in cases:
        args = trunk_inputs(policies[dtype], batch, rng)
        out = got_forward_fused(*args)
        torch.cuda.synchronize()
        ref = got_forward_plain(*args)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (batch, cfg.model.latent_size),
              f"K1 output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              "non-finite K1 output")
        err = (out.float() - ref.float()).abs()
        if dtype == "float32":
            ok = bool((err <= F32_TOL + F32_TOL * ref.abs()).all())
            scale = ref.abs().max().item()
        else:
            errs["K1"].add(out, ref)
            ok, scale = errs["K1"].max_ok, ref.float().abs().max().item()
        print(f"K1 vs plain {dtype} B={batch}: max|err| {err.max().item():.3e}"
              f" mean|err| {err.mean().item():.3e} max|ref| {scale:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K1 disagrees with its plain version ({dtype}, B={batch})")
        worst[dtype] = max(worst.get(dtype, 0.0), err.max().item())
        if dtype == "bfloat16":
            for name, wrong in wrongs.items():
                mx, mean, _ = errs[name].add(wrong(*args), ref)
                print(f"  wrong trunk ({name}) vs plain B={batch}: max|err| "
                      f"{mx:.3e} mean|err| {mean:.3e}", flush=True)
    for name, e in errs.items():
        print(f"{name} vs plain, bf16 batches pooled: mean|err| {e.mean:.3e}"
              f" (limit {BF16_MEAN * e.scale:.3e}), every max within "
              f"2^-7 L: {e.max_ok}; {'ok' if e.ok else 'FAIL'}", flush=True)
    check(errs["K1"].ok, "K1 disagrees with its plain version (bf16 pooled)")
    for name in wrongs:
        check(not errs[name].ok, f"the bf16 limits pass a wrong trunk "
              f"({name})")
    return worst


def phase_policy(cfg, flat):
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain
    from dgvit_tpu_torch.serve import make_action_fn

    g = np.load(GOLDEN)
    check(int(g["seed"]) == GOLDEN_SEED, "golden file seed")
    obs, goal = golden_inputs()
    act = make_action_fn(cfg, flat, device=DEVICE)         # bf16
    a = act(obs, goal)
    check(a.shape == (GOLDEN_FRAMES, cfg.sac.action_dim) and
          bool(np.isfinite(a).all()), "served actions: shape or non-finite")
    with torch.no_grad():
        o = torch.from_numpy(obs).to(DEVICE)
        gl = torch.from_numpy(goal).to(DEVICE)
        pol = act.policy
        lat = got_forward_plain(*pol.trans.trunk_args(o, pol.fc_embed(gl)))
        a_plain = torch.tanh(pol.from_latent(lat)[0]).float()
    d_plain = np.abs(a - a_plain.cpu().numpy())
    e_plain = d_plain.max()
    e_gold = np.abs(a - g["actions"]).max()
    act32 = make_action_fn(cfg, flat, dtype=torch.float32, device=DEVICE)
    e_gold32 = np.abs(act32(obs, goal) - g["actions"]).max()
    with torch.no_grad():
        pol = act32.policy
        lat = pol.trans(o, pol.fc_embed(gl), inference=True).cpu().numpy()
    e_lat32 = np.abs(lat - g["latents"]).max()
    print(f"policy bf16 kernel vs bf16 plain on card: max|err| {e_plain:.3e}"
          f" mean|err| {d_plain.mean():.3e}")
    print(f"policy bf16 kernel vs JAX fp32 golden: max|err| {e_gold:.3e}")
    print(f"policy fp32 kernel vs JAX fp32 golden: actions {e_gold32:.3e}, "
          f"latents {e_lat32:.3e}", flush=True)
    check(e_plain <= ACTION_BF16, "bf16 actions: kernel vs plain")
    check(e_gold <= ACTION_BF16_VS_FP32, "bf16 actions vs JAX golden")
    check(e_gold32 <= ACTION_FP32 and e_lat32 <= ACTION_FP32,
          "fp32 kernel path vs JAX golden")
    return act


def phase_serving(act, rng):
    """The main path: concurrent clients through the batching server."""
    import numpy as np

    from dgvit_tpu_torch.ops.got_megakernel import got_forward_fused
    from dgvit_tpu_torch.serve import BatchingActorServer

    n_cli, reqs, buckets = 32, 4, (1, 8, 16, 32)
    frames = rng.uniform(0, 1, (n_cli, 128, 160)).astype(np.float32)
    goals = np.stack([rng.uniform(0, 1, n_cli), rng.uniform(-1, 1, n_cli)],
                     axis=1).astype(np.float32)
    # the direct answer for each row (one frame a call), and a warm bucket
    # grid, before the counted run
    direct = np.concatenate([act(frames[i:i + 1], goals[i:i + 1])
                             for i in range(n_cli)])
    for b in buckets:
        act(frames[:b], goals[:b])
    answers = [[None] * reqs for _ in range(n_cli)]

    got_forward_fused.launches = 0
    with BatchingActorServer(act, max_wait_ms=4.0, buckets=buckets) as srv:
        barrier = threading.Barrier(n_cli)

        def client(i):
            barrier.wait()
            for r in range(reqs):
                answers[i][r] = srv.act(frames[i], goals[i], timeout=120)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_cli)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        stats = srv.stats()
    launches = got_forward_fused.launches

    check(stats["requests"] == n_cli * reqs and all(
        a is not None and a.shape == (2,) for row in answers for a in row),
        "a client got no answer")
    # the heads' bf16 matmuls may take another library kernel at another
    # batch size, so a row can differ from its batch-of-one answer by a
    # bf16 rounding of the action (2^-8 at |a| < 1)
    worst = max(np.abs(answers[i][r] - direct[i]).max()
                for i in range(n_cli) for r in range(reqs))
    print(f"serving: {n_cli * reqs} requests from {n_cli} clients in "
          f"{elapsed:.4f} s = {n_cli * reqs / elapsed:.1f} actions/s (host "
          f"clock); {stats['dispatches']} dispatches, mean batch "
          f"{stats['mean_batch']:.2f}, padded rows {stats['padded_rows']}; "
          f"K1 launches {launches}; max|answer - direct| {worst:.3e}",
          flush=True)
    check(worst <= 2.0 ** -7, "served answers differ from direct act")
    check(launches >= 1 and launches == stats["dispatches"],
          "serving did not go through K1")
    return launches


def phase_times(cfg, policies, rng):
    import torch

    from dgvit_tpu_torch.ops.got_megakernel import (got_forward_fused,
                                                    got_forward_plain)

    rows = {}
    for batch, reps in TIMED_BATCHES:
        args = trunk_inputs(policies["bfloat16"], batch, rng)
        ms = cuda_ms(lambda: got_forward_fused(*args), reps)
        plain = cuda_ms(lambda: got_forward_plain(*args), max(1, reps // 5),
                        runs=5)
        bnd, by = bound_ms(*k1_work(cfg, batch, "bfloat16"), "bfloat16")
        rows[batch] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        print(f"K1 bf16 B={batch}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bnd:.5f} ms ({by}), "
              f"{batch / ms * 1e3:.0f} frames/s", flush=True)
    return rows


# --------------------------------------------------------------------------
# the SAC slice
# --------------------------------------------------------------------------

# Tolerances of the training kernels against their plain versions on the
# card, per tensor (the output, or dx and each of the 11 weight grads),
# with L the largest |value| of the plain version's tensor.
# fp32: another summation order; max |err| <= 1e-5 L.
# bf16: the same rounding points, so most values agree bit for bit; a sum
# taken in another order can flip one bf16 rounding, and a flip in an
# intermediate (qkv, p, dpre, dqkv) moves what follows by about one ulp of
# its own magnitude. Each tensor: max |err| <= 2^-6 L; pooled over every
# tensor of a kernel's bf16 batches: mean |err| / L <= 2^-18. An H100
# read pooled 1.2e-6 (K4) and <= 5e-8 (K2f, K3f, K3b), and 1.9e-5 / 2.8e-5
# for the wrong K2b / K3b backward (autograd of the plain forward); every
# max stayed within 2^-6 L for both. K2b read 3.3e-7 with an FMA body and
# 1.3e-6 with its tensor-core body (an H100 80GB HBM3 at 700 W): the
# tensor cores' fp32 sums flip more bf16 roundings, still 3x under the
# limit and 15x under the wrong backward. K3b at B=256 read 1.6e-7 with
# its FMA body and 7.1e-7 with its tensor-core body on the same draws;
# pooled, the tensor-core K3b read 4.7e-8 and its wrong versions 2.8e-5
# (autograd) and 2.7e-5 (k and v in fp32). ds, dq and dk|dv left in fp32
# read only 1.7e-6 to 2.2e-6 by batch: these weights' dx is carried by
# its CLS row, which that rounding barely reaches, so it is no wrong
# version the limits can see.
TRAIN_F32_MAX = 1e-5
TRAIN_BF16_MAX, TRAIN_BF16_MEAN = 2.0 ** -6, 2.0 ** -18
# The fp32 SAC update through the kernels against the same update through
# the plain versions on the card, and against the JAX golden update on the
# CPU (fp32, other summation orders): the six metrics and each gradient's
# norm within rtol 1e-4 + atol 1e-6, every gradient element within 1e-4 of
# its tensor's largest |value| (kernel against plain). Each parameter's
# update norm within rtol 1e-2 + 2^-22 |p| + 1e-6, and every parameter
# within 2.2 lr of the plain update's. The update is looser because the
# golden state takes Adam's first step, lr * g / (|g| + 1e-8): 22% of the
# gradient elements are below 1e-6 (most exact zeros behind dead ReLUs),
# and those near 1e-8 take steps anywhere in (0, lr) set by the low bits
# of their gradients, which another summation order changes (an H100 read
# 0.24% on one norm, the CPU 0.11%); and new - old of a parameter p
# carries the fp32 rounding of p (the target's Polyak step, tau * lr, is a
# few ulps).
METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha",
           "entropy")
SAC_RTOL, SAC_ATOL, UPDATE_RTOL = 1e-4, 1e-6, 1e-2


def golden_ref(g):
    """The golden file as a run of `golden_update` (metrics and norms)."""
    return {"metrics": {k: float(g[k]) for k in METRICS},
            **{kind: {str(n): float(v) for n, v in
                      zip(g[f"{kind}_names"], g[f"{kind}_norms"])}
               for kind in ("grad", "update")}}


def update_mismatches(run, ref):
    """Each metric, gradient norm and update norm of `run` off `ref` beyond
    its tolerance, and the largest relative difference of each kind."""
    bad, worst = [], {}
    for kind in ("metrics", "grad", "update"):
        for name, r in ref[kind].items():
            a = run[kind][name]
            tol = SAC_RTOL * abs(r) + SAC_ATOL
            if kind == "update":
                tol = (UPDATE_RTOL * abs(r) + SAC_ATOL
                       + 2.0 ** -22 * run["param_norm"].get(name, 0.0))
            if not abs(a - r) <= tol:
                bad.append(f"{kind} {name}: {a:.7g} vs {r:.7g}")
            worst[kind] = max(worst.get(kind, 0.0),
                              abs(a - r) / max(abs(r), 1e-30))
    return bad, worst


def unflatten(flat):
    """'/'-joined flat parameter paths -> the nested tree."""
    tree = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def critic_params(seed=CRITIC_SEED, d=64, heads=4, dim_head=64, mlp=2048,
                  n_patch=64, pd=320, depth=4, action=2, pstate=2):
    """A flagship GoT critic's parameters in the JAX package's flat layout,
    drawn with numpy: Xavier-uniform kernels, torch-default uniform biases,
    a standard-normal positional embedding, norm scales near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    out = {}

    def dense(name, fi, fo, bias=True):
        b = math.sqrt(6.0 / (fi + fo))
        out[f"{name}/kernel"] = f32(rng.uniform(-b, b, (fi, fo)))
        if bias:
            c = 1.0 / math.sqrt(fi)
            out[f"{name}/bias"] = f32(rng.uniform(-c, c, fo))

    def norm(name):
        out[f"{name}/scale"] = f32(1 + 0.1 * rng.standard_normal(d))
        out[f"{name}/bias"] = f32(0.05 * rng.standard_normal(d))

    inner = heads * dim_head
    dense("fc_embed", pstate, d)
    dense("trans/patch_embed", pd, d)
    out["trans/pos_embedding"] = f32(rng.standard_normal((1, n_patch + 1, d)))
    for i in range(depth):
        blk = f"trans/transformer/block_{i}"
        norm(f"{blk}/attn_norm")
        dense(f"{blk}/attn/to_qkv", d, 3 * inner, bias=False)
        b = math.sqrt(6.0 / (inner + d))
        out[f"{blk}/attn/to_out/kernel"] = f32(rng.uniform(-b, b, (inner, d)))
        c = 1.0 / math.sqrt(inner)
        out[f"{blk}/attn/to_out/bias"] = f32(rng.uniform(-c, c, d))
        norm(f"{blk}/ff_norm")
        dense(f"{blk}/ff/fc1", d, mlp)
        dense(f"{blk}/ff/fc2", mlp, d)
    out["trans/norm_out/g"] = f32(1 + 0.1 * rng.standard_normal(d))
    for heads_ in (("fc1", "fc2", "fc3"), ("fc11", "fc21", "fc31")):
        for name, fi, fo in zip(heads_, (d + action, 128, 32),
                                (128, 32, action)):
            dense(name, fi, fo)
    return out


def golden_params():
    """(actor, critic) flat parameters of the golden SAC state: the trained
    actor and the seeded critic."""
    import numpy as np

    with np.load(ACTOR) as data:
        actor = {k: np.asarray(data[k]) for k in data.files}
    return actor, critic_params()


def golden_batch(seed=GOLDEN_SAC_SEED, b=GOLDEN_SAC_BATCH):
    """A seeded replay batch of flagship (128, 160) depth frames."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    return {"obs": f(b, 128, 160), "pobs": f(b, 2),
            "act": rng.uniform(-1, 1, (b, 2)).astype(np.float32),
            "rew": rng.normal(0, 1, (b, 1)).astype(np.float32),
            "next_obs": f(b, 128, 160), "next_pobs": f(b, 2),
            "done": np.zeros((b, 1), np.float32)}


def sac_state(agent, actor_flat, critic_flat):
    """The agent's fresh state with these actor and critic parameters (the
    target a copy of the critic; fresh Adam; log_alpha = log sac.alpha)."""
    from dgvit_tpu_torch.models import params_from_jax

    state = agent.init_state()
    state.actor.load_state_dict(params_from_jax(actor_flat))
    critic = params_from_jax(critic_flat)
    state.critic.load_state_dict(critic)
    state.critic_target.load_state_dict(critic)
    return state


def golden_update(device, g):
    """One fp32 update of the golden state on `device` with the golden
    noise, dropout off: metrics, per-parameter gradients and their norms,
    update norms, and the parameters after it (port names)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config

    cfg = Config.from_dict({"model": {"emb_dropout": 0.0}})
    agent = SACAgent(cfg, dtype=torch.float32, device=device,
                     seed=GOLDEN_SAC_SEED)
    state = sac_state(agent, *golden_params())
    kinds = ("actor", "critic", "critic_target")
    before = {k: {n: p.detach().clone() for n, p in
                  getattr(state, k).named_parameters()} for k in kinds}
    alpha0 = state.log_alpha.item()
    state, m = agent.learn(state, golden_batch(),
                           noise=(g["noise_next"], g["noise_pi"]))
    grads = {f"{k}.{n}": p.grad.detach().clone() for k in ("actor", "critic")
             for n, p in getattr(state, k).named_parameters()}
    params = {f"{k}.{n}": p.detach().clone() for k in kinds
              for n, p in getattr(state, k).named_parameters()}
    update = {name: (p - before[name.split(".")[0]][name.split(".", 1)[1]])
              .norm().item() for name, p in params.items()}
    update["log_alpha"] = abs(state.log_alpha.item() - alpha0)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": grads, "params": params, "update": update,
            "grad": {k: v.norm().item() for k, v in grads.items()},
            "param_norm": {k: v.norm().item() for k, v in params.items()}}


def kernel_counters():
    """Each kernel wrapper of the port, by the kernel's short name."""
    from dgvit_tpu_torch.ops.attention import attention_fused
    from dgvit_tpu_torch.ops.cls_block import cls_bwd_fused, cls_fwd_fused
    from dgvit_tpu_torch.ops.fused_block import fused_attention_section
    from dgvit_tpu_torch.ops.fused_preprocess import preprocess_depth_fused
    from dgvit_tpu_torch.ops.fused_transformer import (block_bwd_fused,
                                                       block_fwd_fused)
    from dgvit_tpu_torch.ops.got_megakernel import (blocks_cls_forward_fused,
                                                    got_forward_fused)
    from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_fused

    return {"K1": got_forward_fused, "K4": blocks_cls_forward_fused,
            "K2f": block_fwd_fused, "K2b": block_bwd_fused,
            "K3f": cls_fwd_fused, "K3b": cls_bwd_fused,
            "K5": preprocess_depth_fused, "K6": trunk_bwd_fused,
            "K7": fused_attention_section, "K8": attention_fused}


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls (K1-K4, K6, K7) to the plain
    versions (on the same card), for the kernel-against-plain comparison
    of a whole update or a whole route."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_block as fb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_plain

    swaps = [(ft, "block_fwd_fused", ft.block_fwd_plain),
             (ft, "block_bwd_fused", ft.block_bwd_plain),
             (cb, "cls_fwd_fused", cb.cls_fwd_plain),
             (cb, "cls_bwd_fused", cb.cls_bwd_plain),
             (gm, "_launch_blocks", gm.blocks_forward_plain),
             (gm, "trunk_bwd_fused", trunk_bwd_plain),
             (gm, "_launch", gm.got_forward_plain),
             (fb, "_launch", fb.attention_section_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def autograd_bwd(plain_fwd):
    """A wrong bf16 backward: autograd of the plain forward, which rounds
    gradients wherever the forward casts, not at the TPU kernel's
    points."""
    import torch

    def bwd(x, dy, w, heads, dim_head):
        xr = x.detach().requires_grad_()
        wr = [t.detach().requires_grad_() for t in w]
        gs = torch.autograd.grad(plain_fwd(xr, wr, heads, dim_head),
                                 [xr, *wr], dy)
        return gs[0], tuple(gs[1:])
    return bwd


class TrainErrors:
    """Per-tensor |err| of one kernel (or a wrong version of it) against
    the plain version over the bf16 batches: each tensor's max against
    2^-6 L, the pooled mean of |err| / L against TRAIN_BF16_MEAN."""

    def __init__(self):
        self.sum = self.count = 0.0
        self.max_ok, self.worst = True, 0.0

    def add(self, pairs):
        for out, ref in pairs:
            err = (out.float() - ref.float()).abs()
            scale = max(ref.float().abs().max().item(), 1e-30)
            self.sum += err.sum().item() / scale
            self.count += err.numel()
            self.worst = max(self.worst, err.max().item())
            self.max_ok &= err.max().item() <= TRAIN_BF16_MAX * scale

    @property
    def mean(self):
        return self.sum / self.count

    @property
    def ok(self):
        return self.max_ok and self.mean <= TRAIN_BF16_MEAN


def train_inputs(nets, batch, rng):
    """Per net ('actor', 'critic'): the embedded stream of seeded frames,
    the stream entering the last block, the blocks' and final norm's
    weights as the kernels take them, and seeded output gradients."""
    import torch
    import torch.nn.functional as F

    from dgvit_tpu_torch.ops.fused_transformer import block_fwd_plain

    dev = torch.device(DEVICE)
    img = torch.from_numpy(rng.uniform(0, 1, (batch, 128, 160))
                           .astype("float32")).to(dev)
    goal = torch.from_numpy(rng.uniform(-1, 1, (batch, 2))
                            .astype("float32")).to(dev)
    out = {}
    with torch.no_grad():
        for name, net in nets.items():
            tok = net.fc_embed(goal)
            if name == "critic":
                tok = F.relu(tok)
            x = net.trans.embed(img, tok).contiguous()
            cdt = x.dtype
            _, _, blocks, fn = net.trans.fused_params(cdt)
            heads, dh = net.trans.heads, net.trans.dim_head
            last = x
            for w in blocks[:-1]:
                last = block_fwd_plain(last, w, heads, dh)
            dy = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
                "float32")).to(dev).to(cdt)
            out[name] = dict(x=x, last=last, blocks=blocks, fn=fn,
                             heads=heads, dh=dh, dy2=dy(batch, 65, x.shape[2]),
                             dy3=dy(batch, x.shape[2]))
    return out


def train_cases(inp):
    """(name, kernel call, plain call, {what: wrong call}) of each
    training kernel on these inputs: K4 on the actor's trunk, K2 on the
    actor's first block, K3 on the critic's last block. Each wrong call
    is the plain version with one rounding point or form moved (or, for
    the backwards, autograd's rounding points), which the bf16 limits must
    see."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm

    a, c = inp["actor"], inp["critic"]
    hd = (a["heads"], a["dh"])
    k4 = (a["x"], a["blocks"], a["fn"], *hd, "rms")
    k2 = (a["x"], a["blocks"][0], *hd)
    k2b = (a["x"], a["dy2"], a["blocks"][0], *hd)
    k3 = (c["last"], c["blocks"][-1], *hd)
    k3b = (c["last"], c["dy3"], c["blocks"][-1], *hd)
    autograd = "autograd of the plain forward"
    return [
        ("K4", lambda: gm.blocks_cls_forward_fused(*k4),
         lambda: gm.blocks_forward_plain(*k4),
         {"erf GELU": lambda: k4_erf_gelu(*k4),
          "fp32 residual": lambda: k4_f32_residual(*k4)}),
        ("K2f", lambda: ft.block_fwd_fused(*k2),
         lambda: ft.block_fwd_plain(*k2),
         {"fp32 probabilities": lambda: k2f_f32_probs(*k2)}),
        ("K2b", lambda: ft.block_bwd_fused(*k2b),
         lambda: ft.block_bwd_plain(*k2b),
         {autograd: lambda: autograd_bwd(ft.block_fwd_plain)(*k2b)}),
        ("K3f", lambda: cb.cls_fwd_fused(*k3),
         lambda: cb.cls_fwd_plain(*k3), {}),
        ("K3b", lambda: cb.cls_bwd_fused(*k3b),
         lambda: cb.cls_bwd_plain(*k3b),
         {autograd: lambda: autograd_bwd(cb.cls_fwd_plain)(*k3b),
          "k and v in fp32": lambda: k3b_f32_kv(*k3b)}),
    ]


def tensors(result):
    """The output, or dx and the 11 grads, as one list."""
    if isinstance(result, tuple):
        return [result[0], *result[1]]
    return [result]


def build_nets(actor_flat, critic_flat):
    """The trained actor and the seeded critic on the card, per dtype."""
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.models import build_actor, build_critic
    from dgvit_tpu_torch.models import params_from_jax

    cfg = Config()
    nets = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        actor, critic = build_actor(cfg, dtype=dt), build_critic(cfg, dtype=dt)
        actor.load_state_dict(params_from_jax(actor_flat))
        critic.load_state_dict(params_from_jax(critic_flat))
        nets[dtype] = {"actor": actor.to(DEVICE).eval(),
                       "critic": critic.to(DEVICE).eval()}
    return nets


def phase_train_kernels(nets, rng):
    """Phase 5: each training kernel against its plain version."""
    import torch

    errs = {name: TrainErrors() for name in ("K4", "K2f", "K2b", "K3f",
                                              "K3b")}
    wrong = {}
    worst = {}
    for dtype, batches in TRAIN_BATCHES.items():
        for batch in batches:
            for name, kern, plain, bads in train_cases(
                    train_inputs(nets[dtype], batch, rng)):
                out = tensors(kern())
                torch.cuda.synchronize()
                ref = tensors(plain())
                check(all(o.shape == r.shape and o.dtype == r.dtype
                          for o, r in zip(out, ref)) and len(out) == len(ref),
                      f"{name} output shapes/dtypes")
                check(all(bool(torch.isfinite(o.float()).all()) for o in out),
                      f"non-finite {name} output")
                pairs = list(zip(out, ref))
                mx = max((o.float() - r.float()).abs().max().item()
                         for o, r in pairs)
                key = (name, dtype)
                worst[key] = max(worst.get(key, 0.0), mx)
                if dtype == "float32":
                    ok = all((o - r).abs().max().item()
                             <= TRAIN_F32_MAX * r.abs().max().item()
                             for o, r in pairs)
                    print(f"{name} vs plain fp32 B={batch}: max|err| "
                          f"{mx:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                    check(ok, f"{name} disagrees with its plain version "
                          f"(fp32, B={batch})")
                    continue
                e = TrainErrors()
                e.add(pairs)
                errs[name].add(pairs)
                line = (f"{name} vs plain bf16 B={batch}: max|err| {mx:.3e}, "
                        f"mean|err|/L {e.mean:.3e}, every max within 2^-6 L:"
                        f" {e.max_ok}")
                for what, bad in bads.items():
                    w = TrainErrors()
                    w.add(zip(tensors(bad()), ref))
                    wrong.setdefault((name, what), TrainErrors()).add(
                        zip(tensors(bad()), ref))
                    line += (f"; wrong ({what}) mean|err|/L {w.mean:.3e}, "
                             f"max {w.worst:.3e}")
                print(line, flush=True)
                check(e.max_ok, f"{name} disagrees with its plain version "
                      f"(bf16, B={batch})")
    for name, e in errs.items():
        print(f"{name} bf16 batches pooled: mean|err|/L {e.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}) {'ok' if e.ok else 'FAIL'}", flush=True)
        check(e.ok, f"{name} disagrees with its plain version (bf16 pooled)")
    for (name, what), e in wrong.items():
        print(f"wrong {name} ({what}), bf16 pooled: mean|err|/L "
              f"{e.mean:.3e}, every max within 2^-6 L: {e.max_ok}; "
              f"{'FAIL' if not e.ok else 'passes'}", flush=True)
        check(not e.ok, f"the bf16 limits pass a wrong {name} ({what})")
    return worst


# 16 more tokens for phase 5b: 81, a 128x160 frame in 16x16 patches, one
# more row than the tensor-core bodies hold
EXTRA_TOKENS = 16
# K4's latent in one batch of phase 5b is held by frame, as phase 13
# holds K6's dx. A flip anywhere in a frame moves that frame's
# CLS row through four blocks, so a few frames carry a batch's pooled
# mean: the unchanged FMA K4 pooled 1.26e-5 on phase 5b's batch of 32 at
# 81 tokens (an H100 80GB HBM3 at 700 W), and the plain K4 with exact
# (float64) sums pools 5.6e-6 to 1.1e-5 on such batches against the fp32
# plain K4 (chip_numerics.py 7 8, on the CPU), over phase 5's 2^-18. By
# frame the same exact sums keep 69-88% of frames within 2^-18, an erf
# GELU 53-59% and an fp32 residual none: phase 13's rule, two thirds of
# the frames, separates them.


def narrow_block(w, heads=2, dim_head=32, mlp=256):
    """A full block of 2 x 32 heads and a 256-wide MLP cut from a trained
    block (its first head's q, k, v columns and out-projection rows, its
    first MLP columns): off the flagship widths, with trained magnitudes."""
    import torch

    inner, cut = w[3].shape[0], heads * dim_head
    wqkv = torch.cat([w[2][:, p * inner:p * inner + cut] for p in range(3)],
                     dim=1)
    return tuple(t.contiguous() for t in (
        w[0], w[1], wqkv, w[3][:cut], w[4], w[5], w[6], w[7][:, :mlp],
        w[8][:mlp], w[9][:mlp], w[10]))


def off_by_one(t):
    """A copy of t whose data starts 2 bytes past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


def latent_frames_within(out, ref):
    """The share of frames whose latent (a row of K4's output) is within
    phase 5's pooled limit of the plain latent: mean |err| / L over the
    frame's values, L the plain batch's largest |value|."""
    scale = ref.float().abs().max().clamp(min=1e-30)
    per = (out.float() - ref.float()).abs().mean(dim=-1) / scale
    return (per <= TRAIN_BF16_MEAN).float().mean().item()


def phase_bwd_widths(nets, rng):
    """Phase 5b: the bf16 full-block forward (K2f, K4) and backward (K2b,
    K3b, K6) take the tensor-core bodies at the flagship widths and the
    FMA bodies elsewhere (more tokens than 80, narrow heads, an unaligned
    x); there K2f, K2b and K3b agree with their plain versions within
    phase 5's limits, K6 within phase 13's, and K4 within phase 5's
    per-tensor max and phase 13's per-frame rule (see the note at
    EXTRA_TOKENS). K6 also with only its CLS block's w1 unaligned (the FMA
    bodies, no launch error). The actor's trained blocks on its embedded stream of
    seeded frames, at B=32 (K3b: its last block on the stream that enters
    it, from the plain forward of the blocks before)."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import (tensor_core_trunk,
                                                 trunk_bwd_fused,
                                                 trunk_bwd_plain)

    a = train_inputs(nets["bfloat16"], 32, rng)["actor"]
    x, blocks, dy3 = a["x"], a["blocks"], a["dy3"]
    check(ft.tensor_core_bwd(x, blocks[0], a["dh"], a["dy2"])
          and ft.tensor_core_bwd(x, blocks[-1], a["dh"], dy3)
          and all(ft.tensor_core_fwd(x, w, a["dh"]) for w in blocks),
          "the flagship bf16 blocks do not take the tensor-core bodies")
    longer = torch.cat([x, x.roll(1, 0)[:, 1:1 + EXTRA_TOKENS]], dim=1)
    cases = [
        (f"{longer.shape[1]} tokens", longer.contiguous(), blocks, 4, 64),
        ("2 x 32 heads, mlp 256", x, [narrow_block(w) for w in blocks], 2,
         32),
        ("flagship widths, x unaligned", off_by_one(x), blocks, 4, 64)]
    for what, xs, bl, heads, dh in cases:
        dy2 = torch.from_numpy(rng.standard_normal(xs.shape).astype(
            "float32")).to(DEVICE).bfloat16()
        last = xs
        for w in bl[:-1]:
            last = ft.block_fwd_plain(last, w, heads, dh)
        if xs.data_ptr() % 16:
            last = off_by_one(last)
        check(not ft.tensor_core_bwd(xs, bl[0], dh, dy2)
              and not ft.tensor_core_bwd(last, bl[-1], dh, dy3)
              and not any(ft.tensor_core_fwd(xs, w, dh) for w in bl),
              f"bf16, {what}: would take a tensor-core body")
        e2 = TrainErrors()
        e2.add(zip(tensors(ft.block_fwd_fused(xs, bl[0], heads, dh)),
                   tensors(ft.block_fwd_plain(xs, bl[0], heads, dh))))
        k4 = (xs, bl, a["fn"], heads, dh, "rms")
        out, ref = (gm.blocks_cls_forward_fused(*k4),
                    gm.blocks_forward_plain(*k4))
        e4 = TrainErrors()
        e4.add([(out, ref)])
        within = latent_frames_within(out, ref)
        ok = e2.ok and e4.max_ok and within >= K6_FRAMES_WITHIN
        print(f"bf16 forward, {what}, FMA body: K2f vs plain mean|err|/L "
              f"{e2.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}); K4 vs plain "
              f"mean|err|/L {e4.mean:.3e}, frames within "
              f"{TRAIN_BF16_MEAN:.3e}: {within:.3f} (at least "
              f"{K6_FRAMES_WITHIN:.3f}); every max within 2^-6 L: "
              f"{e2.max_ok and e4.max_ok} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"bf16 forward, {what}: K2f or K4 disagrees with its plain"
              " version")
        e = TrainErrors()
        e.add(zip(tensors(ft.block_bwd_fused(xs, dy2, bl[0], heads, dh)),
                  tensors(ft.block_bwd_plain(xs, dy2, bl[0], heads, dh))))
        e3 = TrainErrors()
        e3.add(zip(tensors(cb.cls_bwd_fused(last, dy3, bl[-1], heads, dh)),
                   tensors(cb.cls_bwd_plain(last, dy3, bl[-1], heads,
                                            dh))))
        args = (xs, dy3, bl, a["fn"], heads, dh, "rms")
        e6 = TrainErrors()
        e6.add(zip(trunk_tensors(trunk_bwd_fused(*args)),
                   trunk_tensors(trunk_bwd_plain(*args))))
        ok = e.ok and e3.ok and e6.max_ok and e6.mean <= K6_BF16_MEAN
        print(f"bf16 backward, {what}, FMA body: K2b vs plain mean|err|/L "
              f"{e.mean:.3e}, K3b {e3.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}), K6 vs plain mean|err|/L "
              f"{e6.mean:.3e} (limit {K6_BF16_MEAN:.3e}), every max within "
              f"2^-6 L: {e.max_ok and e3.max_ok and e6.max_ok} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"bf16 backward, {what}: disagrees with its plain version")
    # K6 with only its CLS block's w1 off a 16-byte boundary: every block
    # on the FMA bodies (the launch holds all of them to the tensor-core
    # bodies' alignment), within phase 13's limits
    bl = [*blocks[:-1], tuple(off_by_one(t) if j == 7 else t
                              for j, t in enumerate(blocks[-1]))]
    check(tensor_core_trunk(x, blocks, a["dh"])
          and not tensor_core_trunk(x, bl, a["dh"]), "K6 with the CLS "
          "block's w1 unaligned would take the tensor-core bodies")
    args = (x, dy3, bl, a["fn"], a["heads"], a["dh"], "rms")
    e6 = TrainErrors()
    e6.add(zip(trunk_tensors(trunk_bwd_fused(*args)),
               trunk_tensors(trunk_bwd_plain(*args))))
    ok = e6.max_ok and e6.mean <= K6_BF16_MEAN
    print(f"bf16 backward, flagship widths, the CLS block's w1 unaligned, FMA"
          f" bodies: K6 vs plain mean|err|/L {e6.mean:.3e} (limit "
          f"{K6_BF16_MEAN:.3e}), every max within 2^-6 L: {e6.max_ok} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "K6 with the CLS block's w1 unaligned disagrees with its plain "
          "version")


# Phase 5c: the weight products of the backwards (wgrad_mma_kernel for
# bf16 where it takes the operands, else wgrad_kernel) against
# wgrad_plain, which sums the kernels' row segments in their order.
# (rows, K, N, row stride of A): the default update's at B=256 (K2b's
# four, then K3b's CLS operands, row 0 of each 65-row frame), then
# awkward ones: rows not a multiple of the 64-row chunk with K and N not
# multiples of 64, 2 x 32 heads' qkv at 81 tokens, K not a multiple of 8
# (the FMA kernel). Each also with A one element off a 16-byte boundary
# (the FMA kernel). Both sum in fp32 within a segment in another order,
# so bf16 results agree but for a flipped rounding now and then: phase
# 5's limits (each max 2^-6 L, pooled mean 2^-18); fp32 1e-5 L.
WGRAD_SHAPES = ((16640, 64, 768, 64), (16640, 256, 64, 256),
                (16640, 64, 2048, 64), (16640, 2048, 64, 2048),
                (256, 64, 256, 65 * 64), (256, 64, 2048, 64),
                (1000, 40, 96, 40), (2592, 64, 192, 64), (500, 36, 64, 36))
WGRAD_SEED = 8


def wgrad_work(rows, k, n, esize=2):
    """FLOPs and bytes of one weight product: A and B read once, C
    written once."""
    return 2 * rows * k * n, (rows * (k + n) + k * n) * esize


def product_times(fn, a, b) -> dict:
    """One weight product's time from CUDA events (`ms`; with the
    wrapper's host work, which bounds the small products) and from the
    profiler (`device_ms`, its kernels alone): `fn(a, b)` (the kernel's
    wrapper) beside `a.t() @ b` (`library_ms`, `library_device_ms`:
    cuBLAS with its sums kept in fp32, no reduced-precision split-K, as
    the kernels keep them)."""
    import torch

    flags = torch.backends.cuda.matmul
    keep = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return dict(ms=cuda_ms(lambda: fn(a, b), 10, runs=5),
                    device_ms=device_ms(lambda: fn(a, b)),
                    library_ms=cuda_ms(lambda: a.t() @ b, 10, runs=5),
                    library_device_ms=device_ms(lambda: a.t() @ b))
    finally:
        flags.allow_bf16_reduced_precision_reduction = keep


def phase_weight_products():
    """Phase 5c: the weight products against their plain version, whose
    row segments (`wgrad_splits`) must be the library's; at the default
    update's shapes their times on the tensor cores beside the FMA
    kernel's (the same call with A unaligned), one PyTorch call for the
    same product (`a.t() @ b`, cuBLAS: fp32 sums, a bf16 result) and the
    bound. Its operands come from a generator of their own (WGRAD_SEED),
    so the later phases draw what they drew before this phase existed."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops.fused_transformer import (_block_lib,
                                                       weight_product,
                                                       wgrad_plain,
                                                       wgrad_splits)

    lib = _block_lib()
    for rows, k, n, _ in WGRAD_SHAPES:
        segs = (lib.weight_product_segments(rows, k, n),
                wgrad_splits(rows, k, n))
        check(segs[0] == segs[1], f"weight product {rows} x ({k}, {n}): the "
              f"library splits it into {segs[0]} row segments, wgrad_splits "
              f"into {segs[1]}")
    times, rng = {}, np.random.default_rng(WGRAD_SEED)
    for dtype in ("bfloat16", "float32"):
        dt, pooled = getattr(torch, dtype), TrainErrors()
        for rows, k, n, lda in WGRAD_SHAPES:
            base = torch.from_numpy(rng.standard_normal(
                rows * lda + 8).astype("float32")).to(DEVICE).to(dt)
            b = torch.from_numpy(rng.standard_normal((rows, n)).astype(
                "float32")).to(DEVICE).to(dt)
            for off in (0, 1):
                a = base[off:].as_strided((rows, k), (lda, 1))
                out, ref = weight_product(a, b), wgrad_plain(a, b)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                mx = (out.float() - ref.float()).abs().max().item()
                what = (f"weight product {dtype} {rows} x ({k}, {n}), A "
                        f"{'un' if off else ''}aligned")
                if dtype == "float32":
                    check(mx <= TRAIN_F32_MAX * scale, f"{what}: max|err| "
                          f"{mx:.3e} over {TRAIN_F32_MAX:.0e} L")
                    continue
                e = TrainErrors()
                e.add([(out, ref)])
                pooled.add([(out, ref)])
                check(e.max_ok, f"{what}: max|err| {mx:.3e} over 2^-6 L")
                if rows in (SAC_BATCH * 65, SAC_BATCH) and off == 0:
                    bnd, by = bound_ms(*wgrad_work(rows, k, n), dtype)
                    times[f"{rows} x ({k}, {n})"] = dict(
                        **product_times(weight_product, a, b),
                        fma_ms=cuda_ms(lambda: weight_product(
                            base[1:].as_strided((rows, k), (lda, 1)), b),
                            3, runs=5),
                        bound_ms=bnd, bound_by=by)
        if dtype == "bfloat16":
            print(f"weight products bf16, {2 * len(WGRAD_SHAPES)} against "
                  f"wgrad_plain: pooled mean|err|/L {pooled.mean:.3e} "
                  f"(limit {TRAIN_BF16_MEAN:.3e}), every max within 2^-6 L:"
                  f" {pooled.max_ok}", flush=True)
            check(pooled.ok, "the bf16 weight products disagree with "
                  "wgrad_plain")
    print("weight products fp32: every max within 1e-5 L", flush=True)
    for shape, t in times.items():
        print(f"weight product bf16 {shape}: tensor cores {t['ms']:.4f} ms "
              f"(device {t['device_ms']:.4f}), FMA kernel {t['fma_ms']:.4f} "
              f"ms, a.t() @ b {t['library_ms']:.4f} ms (device "
              f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
    return times


@contextlib.contextmanager
def trunk_grad_switch():
    """The JAX package's opt-in switch, set while networks are built."""
    import os

    os.environ["DGVIT_TRUNK_GRAD"] = "1"
    try:
        yield
    finally:
        del os.environ["DGVIT_TRUNK_GRAD"]


def phase_sac(actor_flat, critic_flat, per_update=PER_UPDATE, label="SAC"):
    """Phases 6a and 14a, main paths: 5 bf16 learn steps at B=256, every
    step launching exactly `per_update`. Returns the launch counts of the
    run, the median update time, and a closure that runs one more update
    (for the profile)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config

    cfg = Config.from_dict({"model": {"compute_dtype": "bfloat16"},
                            "sac": {"batch_size": SAC_BATCH}})
    agent = SACAgent(cfg, device=DEVICE, seed=SEED)
    check(agent.dtype == torch.bfloat16 and cfg.model.emb_dropout == 0.1,
          "the main path's agent is bf16 with emb-dropout 0.1")
    state = sac_state(agent, actor_flat, critic_flat)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             golden_batch(seed=SEED, b=SAC_BATCH).items()}
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for step in range(SAC_STEPS):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = agent.learn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        vals = {k: float(v) for k, v in m.items()}
        print(f"{label} step {step}: {times[-1] * 1e3:.2f} ms (host clock), "
              f"launches {delta}, " + ", ".join(
                  f"{k} {v:.5g}" for k, v in vals.items()), flush=True)
        check(all(math.isfinite(v) for v in vals.values()),
              f"non-finite {label} metrics at step {step}")
        check(delta == per_update, f"{label} step {step} launches {delta}, "
              f"expected {per_update}")
    launches = {k: fn.launches for k, fn in counters.items()}
    steady = statistics.median(times[1:])
    print(f"{label} bf16 B={SAC_BATCH}: {SAC_STEPS} updates, median of steps "
          f"1-{SAC_STEPS - 1} {steady * 1e3:.2f} ms = {1 / steady:.3f} "
          f"updates/s (host clock, synchronized); first step "
          f"{times[0] * 1e3:.2f} ms; launches over the run {launches}",
          flush=True)
    return launches, steady, lambda: agent.learn(state, batch)


def phase_sac_fp32():
    """Phase 6b: one fp32 update through the kernels against the same
    update through the plain versions on the card and the JAX golden."""
    import numpy as np
    import torch

    g = np.load(GOLDEN_SAC)
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    kern = golden_update(DEVICE, g)
    check(all(counters[k].launches - before[k] == n
              for k, n in PER_UPDATE.items()), "the fp32 update did not go "
          "through the kernels")
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_kernels():
        plain = golden_update(DEVICE, g)
    check(all(fn.launches == before[k] for k, fn in counters.items()),
          "the plain fp32 update launched a kernel")
    bad_g, worst_g = update_mismatches(kern, golden_ref(g))
    bad_p, worst_p = update_mismatches(kern, plain)
    gerr = max(((a - plain["grads"][n]).abs().max()
                / plain["grads"][n].abs().max().clamp(min=1e-30)).item()
               for n, a in kern["grads"].items())
    pmax = max((a - plain["params"][n]).abs().max().item()
               for n, a in kern["params"].items())
    print(f"SAC fp32 update through the kernels: largest relative "
          f"differences from the JAX golden {worst_g}, from the plain "
          f"versions on the card {worst_p}; grads max|err|/L vs plain "
          f"{gerr:.3e}; parameters vs plain: max|diff| {pmax:.3e}",
          flush=True)
    check(not bad_g, f"the fp32 update disagrees with the golden: {bad_g}")
    check(not bad_p, f"the fp32 update disagrees with the plain: {bad_p}")
    check(gerr <= SAC_RTOL, "the fp32 update's grads disagree")
    check(pmax <= 2.2e-3, "the fp32 update's parameters disagree")
    return {"vs_golden": worst_g, "vs_plain": worst_p}, kern


def train_work(kind, batch, n=65, d=64, heads=4, dh=64, mlp=2048, depth=4,
               esize=2):
    """FLOPs and bytes a training kernel needs at the flagship width: each
    input read once, each output written once. The backward recomputes
    the forward and does two products per forward product (3x); K3 runs
    q, attention, out-proj and MLP on one row per frame."""
    inner = heads * dh
    w = d * 3 * inner + inner * d + 2 * d * mlp + mlp + 6 * d   # one block
    full = n * (2 * d * 3 * inner + 4 * heads * n * dh + 2 * inner * d
                + 4 * d * mlp)
    cls = (n * 2 * d * 2 * inner + 2 * d * inner + 4 * heads * n * dh
           + 2 * inner * d + 4 * d * mlp)
    rows = batch * n * d
    if kind == "K4":
        return (batch * ((depth - 1) * full + cls),
                (rows + batch * d + depth * w) * esize + 2 * d * 4)
    if kind == "K2f":
        return batch * full, (2 * rows + w) * esize
    if kind == "K2b":
        return 3 * batch * full, (3 * rows + 2 * w) * esize
    if kind == "K3f":
        return batch * cls, (rows + batch * d + w) * esize
    return 3 * batch * cls, (2 * rows + batch * d + 2 * w) * esize


def phase_train_times(nets, rng):
    """Phase 8b: each training kernel and its plain version at B=256, and
    K4 by depth (its CLS-only block alone, one full block before it) for
    the split of its time; the backwards (K2b, K3b) also by device time,
    split into the per-frame pass, the weight products (wgrad_kernel,
    wgrad_finish) and the vector finish."""
    from dgvit_tpu_torch.ops import got_megakernel as gm

    reps = {"K4": 5, "K2f": 10, "K2b": 5, "K3f": 10, "K3b": 10}
    rows = {}
    inp = train_inputs(nets["bfloat16"], SAC_BATCH, rng)
    a = inp["actor"]
    by_depth = {depth: cuda_ms(lambda: gm.blocks_cls_forward_fused(
        a["x"], a["blocks"][-depth:], a["fn"], a["heads"], a["dh"], "rms"),
        10, runs=5) for depth in (1, 2)}
    print(f"K4 bf16 B={SAC_BATCH} by depth: the CLS-only block "
          f"{by_depth[1]:.4f} ms, one full block and the CLS block "
          f"{by_depth[2]:.4f} ms", flush=True)
    for name, kern, plain, _ in train_cases(inp):
        ms = cuda_ms(kern, reps[name], runs=5)
        pms = cuda_ms(plain, max(1, reps[name] // 2), runs=5)
        bnd, by = bound_ms(*train_work(name, SAC_BATCH), "bfloat16")
        rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by)
        split = ""
        if name in ("K2b", "K3b"):
            by_kernel = device_kernels_ms(kern, calls=20)
            part = lambda word: sum(t for k, t in by_kernel.items()
                                    if word in k)
            rows[name].update(pass_device_ms=part("bwd_kernel"),
                              products_device_ms=part("wgrad"),
                              finish_device_ms=part("vec_finish"))
            split = (f"; device time a call (torch.profiler): per-frame pass "
                     f"{part('bwd_kernel'):.4f} ms, weight products "
                     f"{part('wgrad'):.4f} ms, vector finish "
                     f"{part('vec_finish'):.4f} ms")
        print(f"{name} bf16 B={SAC_BATCH}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bnd:.5f} ms ({by})"
              + (earlier(ms, FMA_DESIGN_MS[name])
                 if name in FMA_DESIGN_MS else "") + split, flush=True)
    return rows


# The CUDA kernels one bf16 update launches by design, counted by name in
# the profile (a name counts every kernel whose name holds it). Default:
# K4 x3 and K2f x6 on the tensor-core forward kernels (the FMA forms
# trunk_kernel and block_fwd_kernel<bf16, false> launch nothing: the
# block_fwd_kernel count is K3f's two), K2b x6, K3b x2 on the tensor-core
# CLS body (its FMA form cls_bwd_kernel<bf16, false> launches nothing),
# and behind them the 34 weight products on the tensor cores (the FMA
# wgrad_kernel launches nothing) with a finish each and the blocks' vector
# finishes. Trunk-gradient: K4 x5 on the tensor-core kernel, K6's
# per-frame pass x2, and behind K6 the 17 weight products of a trunk
# (3 x 4 + 5), on the tensor cores, with a finish each, the blocks' four
# vector finishes and the final norm's.
DEFAULT_CUDA_LAUNCHES = {
    "trunk_mma_kernel": 3, "trunk_kernel": 0, "block_fwd_mma_kernel": 6,
    "block_fwd_kernel": 2, "block_bwd_kernel": 6,
    "cls_bwd_kernel<__nv_bfloat16, true>": 2,
    "cls_bwd_kernel<__nv_bfloat16, false>": 0,
    "trunk_bwd_kernel": 0, "wgrad_mma_kernel": 34, "wgrad_kernel": 0,
    "wgrad_finish": 34, "vec_finish": 8}
TRUNK_CUDA_LAUNCHES = {
    "trunk_mma_kernel": 5, "trunk_kernel": 0, "block_fwd_mma_kernel": 0,
    "block_fwd_kernel": 0, "block_bwd_kernel": 0, "cls_bwd_kernel": 0,
    "trunk_bwd_kernel": 2, "wgrad_mma_kernel": 34, "wgrad_kernel": 0,
    "wgrad_finish": 34, "vec_finish": 10}


def check_profile(seen, want, label):
    """Hold a profiled update's CUDA launches (by kernel name) to the
    design; nothing to hold when the profiler recorded nothing."""
    if seen is None:
        return
    got = {w: sum(c for k, c in seen.items() if w in k) for w in want}
    print(f"CUDA launches of one {label} update: {got}", flush=True)
    check(got == want, f"a {label} update launched {got}, designed {want}")


def phase_profile(update, label="bf16"):
    """Phases 7 and 14c: one bf16 update under torch.profiler: device time
    by CUDA kernel (returned as {kernel name: launches}, None when the
    profiler recorded nothing) and the device's busy share of the update's
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(t for _, t, _ in rows) / 1e3
    if not rows:
        print("profile: no device time recorded (device busy share not "
              "measured)", flush=True)
        return None
    print(f"profile of one {label} update: wall {wall * 1e3:.2f} ms, device "
          f"kernels {busy:.2f} ms = busy share {busy / (wall * 1e3):.3f}",
          flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {t / 1e3:9.3f} ms  x{count:<4d} {t / 1e3 / count:8.3f} ms "
              f"a call  {key[:80]}", flush=True)
    products = [(t, c) for k, t, c in rows if "wgrad" in k]
    print(f"  weight products (wgrad*, their finishes included): "
          f"{sum(t for t, _ in products) / 1e3:.3f} ms over "
          f"{sum(c for _, c in products)} launches", flush=True)
    return {key: count for key, _, count in rows}


# --------------------------------------------------------------------------
# the ingest slice: K5, camera to action, train and evaluate
# --------------------------------------------------------------------------

def camera_frames(n, seed):
    """`n` raw (512, 640) depth frames in metres and their polar goals, as
    a depth camera on the port's kinematic robot would send them: the env
    renders at the camera's own resolution while a seeded random walk
    drives it."""
    import numpy as np

    from dgvit_tpu_torch.envs import KinematicNavEnv

    env = KinematicNavEnv(seed=seed, image_hw=(512, 640))
    rng = np.random.default_rng(seed)
    frames, goals = [], []
    r = env.reset()
    state, goal, t = r.state, r.to_goal, 0
    while len(frames) < n:
        frames.append(state[..., 0] * env.CAM_CLIP[1])
        goals.append(goal[:2])
        s = env.step([float(rng.uniform(0.1, 0.5)),
                      float(rng.uniform(-1.0, 1.0))], t)
        state, goal, t = s.state, s.to_goal, t + 1
        if s.done or t >= 12:
            r = env.reset()
            state, goal, t = r.state, r.to_goal, 0
    return (np.stack(frames).astype(np.float32),
            np.stack(goals).astype(np.float32))


def wrong_chain(raw, seed, sigma, fault):
    """K5's plain chain with one fault: 'image-edge reflect' blurs the
    whole image with the 11-tap kernel and pastes the band's rows, so the
    blur reflects into the image instead of at the band's own edges;
    'round' rounds where the normalisation truncates."""
    import torch

    from dgvit_tpu_torch.ops import fused_preprocess as fp
    from dgvit_tpu_torch.ops import preprocess as pp

    x = raw.float()
    if fault == "round":
        lo = x.amin(dim=(-2, -1), keepdim=True)
        hi = x.amax(dim=(-2, -1), keepdim=True)
        x = torch.clamp(torch.round((x - lo) * (x.new_tensor(255.0)
                        / torch.clamp(hi - lo, min=1e-20))), 0.0, 255.0)
    else:
        x = pp.normalize_depth_f32(x)
    if sigma > 0.0:
        seeds = seed + torch.arange(x.shape[0], device=x.device)
        x = torch.clamp(x + sigma * fp.irwin_hall_noise(seeds, 512, 640),
                        0.0, 255.0)
    x = pp.gaussian_blur(x, 5)
    if fault == "image-edge reflect":
        y1, y2 = pp.center_band(512)
        x = torch.cat([x[:, :y1], pp.gaussian_blur(x, 11)[:, y1:y2],
                       x[:, y2:]], dim=1)
    else:
        x = pp.band_blur(x, 11)
    x = pp.resize_bilinear(x, (128, 160))
    return x / x.new_tensor(255.0)     # a tensor: a true division on CUDA


def phase_k5(rng):
    """Phase 9: K5 against its plain version, its wrong chains and its
    noise."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import fused_preprocess as fp
    from dgvit_tpu_torch.ops import preprocess as pp

    dev = torch.device(DEVICE)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)
    uniform = up(rng.uniform(0.3, 8.0, (max(K5_BATCHES), 512, 640)))
    cases = [(f"uniform B={b}", uniform[:b].contiguous()) for b in K5_BATCHES]
    constant = torch.full((1, 512, 640), 3.25, device=dev)
    cases += [
        ("env frames B=8", up(camera_frames(8, SEED)[0])),
        ("constant B=1", constant),
        ("extreme range B=2", up(rng.uniform(-1e30, 1e30, (2, 512, 640)))),
    ]
    worst = 0.0
    for name, raw in cases:
        for sigma in K5_SIGMAS:
            out = fp.preprocess_depth_fused(raw, SEED, sigma)
            torch.cuda.synchronize()
            ref = fp.preprocess_depth_plain(raw, SEED, sigma)
            check(out.shape == ref.shape == (raw.shape[0], 128, 160)
                  and out.dtype == torch.float32, f"K5 output shape ({name})")
            check(bool(torch.isfinite(out).all()) and out.min().item() >= 0.0
                  and out.max().item() <= 1.0,
                  f"K5 output outside [0, 1] ({name}, sigma {sigma})")
            err = (out - ref).abs()
            mx = err.max().item()
            step = (err > 1e-4).float().mean().item()
            print(f"K5 vs plain {name} sigma={sigma:g}: max|err| {mx:.3e}, "
                  f"share of states off by a u8 step's worth (> 1e-4) "
                  f"{step:.3e}, off at all {(err > 0).float().mean().item():.3e}"
                  f" {'ok' if mx <= K5_MAX else 'FAIL'}", flush=True)
            check(mx <= K5_MAX, f"K5 disagrees with its plain version "
                  f"({name}, sigma {sigma})")
            worst = max(worst, mx)
    check(fp.preprocess_depth_fused(constant, 0, 0.0).abs().max().item()
          == 0.0, "a constant frame must give zeros")

    raw = uniform[:3].contiguous()
    for fault in ("image-edge reflect", "round"):
        for sigma in K5_SIGMAS:
            out = fp.preprocess_depth_fused(raw, SEED, sigma)
            err = (out - wrong_chain(raw, SEED, sigma, fault)).abs()
            right = (out - wrong_chain(raw, SEED, sigma, None)).abs()
            print(f"  wrong chain ({fault}) sigma={sigma:g}: max|err| "
                  f"{err.max().item():.3e}, states over 1e-4 "
                  f"{(err > 1e-4).float().mean().item():.3e} (the same "
                  f"code without the fault: {right.max().item():.3e})",
                  flush=True)
            check(right.max().item() <= K5_MAX, "the chain the wrong "
                  "versions are made from is not K5's plain version")
            check(err.max().item() > K5_MAX,
                  f"K5's limit passes a wrong chain ({fault})")

    # noise: statistics against the chain with torch.randn noise, and the
    # generator's contract
    raw = uniform[:32].contiguous()
    out = fp.preprocess_depth_fused(raw, 7, 50.0)
    gen = torch.Generator(dev).manual_seed(7)
    ref = pp.preprocess_depth(raw, gen, noise_level=50.0)
    d_mean = abs(out.mean().item() - ref.mean().item())
    d_std = abs(out.std().item() - ref.std().item())
    again = fp.preprocess_depth_fused(raw, 7, 50.0)
    other = fp.preprocess_depth_fused(raw, 8, 50.0)
    alone = fp.preprocess_depth_fused(raw[5:6].contiguous(), 7 + 5, 50.0)
    print(f"K5 noise at sigma 50, 32 frames: mean {out.mean().item():.5f} vs "
          f"randn chain {ref.mean().item():.5f}, std {out.std().item():.5f} "
          f"vs {ref.std().item():.5f}; same seed equal "
          f"{torch.equal(out, again)}, next seed equal "
          f"{torch.equal(out, other)}, frame 5 alone with seed + 5 equal "
          f"{torch.equal(alone[0], out[5])}", flush=True)
    check(d_mean <= K5_NOISE_STATS and d_std <= K5_NOISE_STATS,
          "K5's noise statistics differ from the randn chain's")
    check(torch.equal(out, again), "K5 is not deterministic for a seed")
    check(not torch.allclose(out, other), "K5's seeds give the same noise")
    check(not torch.allclose(out[0], out[1]), "K5's frames share their noise")
    check(torch.equal(alone[0], out[5]), "K5: frame alone != frame in batch")
    # seed + 1 shifts the frames' streams by one
    check(torch.equal(other[4], fp.preprocess_depth_fused(
        raw[4:5].contiguous(), 12, 50.0)[0]), "K5: seed + frame")
    return worst


def phase_camera(cfg, flat):
    """Phase 10, a main path: raw camera frames to velocity commands."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import preprocess_depth_auto
    from dgvit_tpu_torch.ops.fused_preprocess import preprocess_depth_plain
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain
    from dgvit_tpu_torch.serve import make_action_fn

    frames, goals = camera_frames(CAMERA_FRAMES, CAMERA_SEED)
    raw = torch.from_numpy(frames).to(DEVICE)
    act = make_action_fn(cfg, flat, env_units=True, device=DEVICE)   # bf16
    act(preprocess_depth_auto(raw, CAMERA_SEED, 50.0), goals)        # warm
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = preprocess_depth_auto(raw, CAMERA_SEED, 50.0)
    cmd = act(states, goals)
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    e = cfg.env
    with torch.no_grad():
        ref_states = preprocess_depth_plain(raw, CAMERA_SEED, 50.0)
        pol = act.policy
        gl = torch.from_numpy(goals).to(DEVICE)
        lat = got_forward_plain(*pol.trans.trunk_args(ref_states,
                                                      pol.fc_embed(gl)))
        a = torch.clamp(torch.tanh(pol.from_latent(lat)[0]).float(),
                        -e.max_action, e.max_action)
        ref = torch.stack([(a[:, 0] + 1.0) * e.linear_cmd_scale,
                           a[:, 1] * e.angular_cmd_scale], dim=1).cpu().numpy()
    worst = np.abs(cmd - ref).max()
    print(f"camera to action: {CAMERA_FRAMES} raw frames -> commands in "
          f"{elapsed * 1e3:.2f} ms (host clock, synchronized by the copy "
          f"back); launches {launches}; linear in [{cmd[:, 0].min():.3f}, "
          f"{cmd[:, 0].max():.3f}] m/s, angular in [{cmd[:, 1].min():.3f}, "
          f"{cmd[:, 1].max():.3f}] rad/s; max|command - plain path| "
          f"{worst:.3e}", flush=True)
    check(cmd.shape == (CAMERA_FRAMES, 2) and bool(np.isfinite(cmd).all()),
          "camera to action: shape or non-finite commands")
    check(bool((cmd[:, 0] >= 0).all()
               and (cmd[:, 0] <= 2 * e.linear_cmd_scale).all()
               and (np.abs(cmd[:, 1]) <= e.angular_cmd_scale).all()),
          "camera to action: commands outside the robot's range")
    check(worst <= ACTION_BF16, "camera to action: kernels vs plain path")
    want = {k: int(k in ("K5", "K1")) for k in counters}
    check(launches == want, f"camera to action launched {launches}, "
          f"expected {want}")
    return launches


def phase_train(out_dir):
    """Phase 11, a main path: the env-in-the-loop trainer at the flagship
    width, resume, the saved actor, and the evaluator."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import (latest_checkpoint,
                                                 load_params_npz)
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.replay import (BatchPrefetcher, ReplayBuffer,
                                        reference_schema)
    from dgvit_tpu_torch.serve import make_action_fn
    from dgvit_tpu_torch.train.evaluate import run_eval
    from dgvit_tpu_torch.train.train_rl import train

    cfg = Config.from_dict({
        "model": {"compute_dtype": "bfloat16"},
        "sac": {"batch_size": SAC_BATCH, "buffer_size": TRAIN_BUFFER},
        "env": {"max_steps": TRAIN_MAX_STEPS},
        "train": {"seed": SEED, "pre_buffer": False, "plot_interval": 10 ** 6,
                  "reward_threshold": 1e9}})
    m = cfg.model
    check((m.block, m.head, m.dim_head, m.mlp_dim, m.latent_size,
           tuple(m.image_size)) == (4, 4, 64, 2048, 64, (128, 160)),
          "the trainer's model is not the flagship")
    counters = kernel_counters()

    def drive(cfg, out_dir, label):
        """`train` from the seed for TRAIN_EPISODES episodes, with its
        launch counts, metrics and the split of its loop checked."""
        for fn in counters.values():
            fn.launches = 0
        timings = {}
        env = KinematicNavEnv(seed=SEED, world="rrc")
        t0 = time.perf_counter()
        out = train(cfg, env, out_dir=out_dir, max_episodes=TRAIN_EPISODES,
                    device=DEVICE, timings=timings)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        steps, updates = timings["env_steps"], timings["updates"]
        print(f"train ({label}): {out['episodes']} episodes, {steps} env "
              f"steps, {updates} updates in {wall:.2f} s (host clock); "
              f"launches {launches}", flush=True)
        check(updates >= 50 and out["state"].itera == updates,
              f"the trainer ({label}) took {updates} updates, expected "
              "about 100")
        want = {**{k: n * updates for k, n in PER_UPDATE.items()},
                "K1": steps}
        check(launches == want, f"train ({label}) launched {launches}, "
              f"expected {want}: every action K1 x1, every update K4 x3, "
              "K2f x6, K2b x6, K3f x2, K3b x2")
        rows = [json.loads(line) for line in
                (Path(out_dir) / "train_gtrl_98.jsonl").read_text()
                .splitlines()]
        check(len(rows) == out["episodes"] and all(
            math.isfinite(v) for r in rows for v in r.values()
            if isinstance(v, float)),
            f"non-finite training metrics ({label})")
        check("qf1_loss" in rows[-1],
              f"the last episode logged no SAC metrics ({label})")
        loop = sum(timings[k] for k in ("env", "act", "sample", "learn"))
        print(f"train loop ({label}): {steps / loop:.2f} env steps/s, "
              f"{updates / loop:.3f} updates/s over the loop's {loop:.2f} s; "
              f"per env step: env {timings['env'] / steps * 1e3:.3f} ms, act "
              f"{timings['act'] / steps * 1e3:.3f} ms; per update: "
              f"sample+copy {timings['sample'] / updates * 1e3:.3f} ms, "
              f"learn {timings['learn'] / updates * 1e3:.3f} ms (host clock, "
              f"synchronized); last episode: " + ", ".join(
                  f"{k} {v:.5g}" for k, v in rows[-1].items()
                  if k not in ("step", "wall_s")), flush=True)
        return out, launches, {"env_steps_per_s": steps / loop,
                               "updates_per_s": updates / loop}

    out, launches, rates = drive(cfg, out_dir, "serial batches")
    state, updates = out["state"], out["state"].itera

    # the saved actor reloads through the flat npz and acts the same
    agent = SACAgent(cfg, device=DEVICE, seed=SEED)
    saved = sorted((Path(out_dir) / "models").glob("*_actor.npz"))
    check(len(saved) == 1, f"saved actors: {saved}")
    act = make_action_fn(cfg, load_params_npz(str(saved[0])), device=DEVICE)
    obs, goal = golden_inputs()
    with torch.no_grad():
        direct = agent.act_batch(state.actor, obs, goal,
                                 evaluate=True).float().cpu().numpy()
    adiff = np.abs(act(obs, goal) - direct).max()
    print(f"saved actor {saved[0].name}: reloaded actions differ from the "
          f"train state's by {adiff:.3e}", flush=True)
    check(adiff == 0.0, "the saved actor does not act as the trained one")

    # a checkpoint was written; resume restores it, and the next update
    # equals the one taken without the restart
    latest = latest_checkpoint(str(Path(out_dir) / "checkpoints"))
    check(latest is not None and latest.endswith(f"step_{updates}"),
          f"no checkpoint of step {updates}: {latest}")
    resumed = train(cfg, KinematicNavEnv(seed=SEED, world="rrc"),
                    out_dir=out_dir, max_episodes=0, resume=True,
                    device=DEVICE)["state"]
    check(resumed is not state and resumed.itera == updates,
          "resume did not restore the update counter")
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             golden_batch(seed=SEED + 1, b=SAC_BATCH).items()}
    _, m1 = agent.learn(state, batch)
    _, m2 = agent.learn(resumed, batch)
    diff = max(abs(float(m1[k]) - float(m2[k])) for k in m1)
    pdiff = max((a - b).abs().max().item()
                for kind in ("actor", "critic", "critic_target")
                for a, b in zip(getattr(state, kind).parameters(),
                                getattr(resumed, kind).parameters()))
    print(f"resume: the next update's metrics differ by {diff:.3e}, the "
          f"parameters after it by {pdiff:.3e}", flush=True)
    check(diff == 0.0 and pdiff == 0.0,
          "the update after resume differs from the one without a restart")

    # the prefetcher on the card: a background thread samples into pinned
    # memory and copies on a side stream. Its batches are the rows the
    # buffer's own sampler gives, and `train` with `sac.prefetch_batches`
    # takes the same run from the same seed: the same launches per action
    # and per update, its own split of the loop.
    rows = {k: v[:, 0] if v.shape[1:] == (1,) else v for k, v in
            golden_batch(seed=SEED + 2, b=300).items()}

    def filled(seed):
        buf = ReplayBuffer(512, reference_schema(), seed=seed)
        buf.add(**rows, engage=np.zeros(300, np.float32))
        return buf

    def take(buf):
        return {k: v for k, v in buf.sample(SAC_BATCH).items()
                if k != "engage"}

    ours, twin = filled(SEED), filled(SEED)
    pf = BatchPrefetcher(lambda: take(ours), device=DEVICE)
    try:
        for _ in range(4):
            got, want = next(pf), take(twin)
            check(all(got[k].is_cuda and torch.equal(
                got[k].cpu(), torch.from_numpy(want[k])) for k in want),
                "a prefetched batch is not the sampler's batch")
    finally:
        pf.close()
    cfg.sac.prefetch_batches = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as prefetch_dir:
        _, _, prefetch_rates = drive(cfg, prefetch_dir, "prefetched batches")
    cfg.sac.prefetch_batches = False
    check(not [t for t in threading.enumerate()
               if t.name == "BatchPrefetcher"],
          "train left its prefetch thread running")

    cfg.env.max_steps = EVAL_MAX_STEPS
    for fn in counters.values():
        fn.launches = 0
    eval_env = KinematicNavEnv(seed=SEED + 1, world="rrc")
    t0 = time.perf_counter()
    rep = run_eval(cfg, eval_env, load_params_npz(str(saved[0])),
                   max_episodes=EVAL_EPISODES, out_dir=out_dir,
                   name=saved[0].name, device=DEVICE)
    eval_s = time.perf_counter() - t0
    k1 = counters["K1"].launches
    print(f"run_eval: {EVAL_EPISODES} episodes, {k1} steps in {eval_s:.2f} s"
          f" = {k1 / eval_s:.1f} steps/s (host clock, the actor's set-up included); "
          f"{rep}", flush=True)
    check(k1 >= EVAL_EPISODES and all(
        fn.launches == 0 for k, fn in counters.items() if k != "K1"),
        "run_eval did not act through K1 alone")
    check(0.0 <= rep["success_rate"] <= 1.0 and rep["collisions"] >= 0
          and (Path(out_dir) / "testing_data.txt").exists(),
          "run_eval's report")
    return launches, {**rates, "prefetch": prefetch_rates}


def k5_work(batch, sigma):
    """The least operations and bytes the function needs for `batch`
    frames, whatever kernel computes it. Every pixel is behind some state
    (a sampled row or column 4i+1, 4i+2 with the 5-tap halo reaches all of
    them), so each takes 2 for the frame's min and max, 5 to normalise
    (subtract, scale, floor, two clips) and, with noise, 20: one operation
    for each of the three random words (the least any generator spends),
    11 to add their 12 bytes, 2 for z, 2 for x + sigma z, 2 clips. A k-tap
    pass costs 2k - 1 an output (k products, k - 1 sums) and runs only
    where a state reads it: outside the band the 5-tap pass down the rows
    on the 204 sampled rows, then along them at the sampled half of the
    columns; in the band both 5-tap passes on all 102 rows (the 11-tap
    pass down the rows reads every one), then the 11-tap passes on the 52
    sampled rows and at the sampled columns of those. 10 per state for
    the bilinear average and the division. Integer operations are counted
    at the fp32 rate. Each frame is read once, each state written once."""
    px, outs = 512 * 640, 128 * 160
    band, sampled_band, sampled_rest = 102, 52, 256 - 52
    taps5 = 9 * ((sampled_rest + band) * 640
                 + sampled_rest * 320 + band * 640)
    taps11 = 21 * (sampled_band * 640 + sampled_band * 320)
    ops = px * (7 + (20 if sigma > 0 else 0)) + taps5 + taps11 + outs * 10
    return batch * ops, batch * (px + outs) * 4


def phase_k5_times(rng):
    """Phase 12: K5 and its plain version, sigma 50."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import fused_preprocess as fp

    raw = torch.from_numpy(rng.uniform(0.3, 8.0, (256, 512, 640)).astype(
        np.float32)).to(DEVICE)
    rows = {}
    for batch, reps in K5_TIMED:
        x = raw[:batch].contiguous()
        ms = cuda_ms(lambda: fp.preprocess_depth_fused(x, SEED, 50.0), reps,
                     runs=5)
        plain = cuda_ms(lambda: fp.preprocess_depth_plain(x, SEED, 50.0), 1,
                        runs=5)
        ops, nbytes = k5_work(batch, 50.0)
        bnd, by = bound_ms(ops, nbytes, "float32")
        rows[batch] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        print(f"K5 fp32 B={batch} sigma=50: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bnd:.5f} ms ({by}: operations "
              f"{ops / PEAK_FLOPS['float32'] * 1e3:.5f} ms, bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.5f} ms), "
              f"{batch / ms * 1e3:.0f} frames/s", flush=True)

    return rows


def k5_cuda_kernels():
    """The CUDA kernels behind K5's wrapper, from torch.profiler over
    K5_PROFILED calls. It runs first, before any SAC update: once an
    update has run in the process, an H100 gave back windows of a few
    launches with their first device events missing, or with none. The
    count is printed; the check is that no other kernel stands behind
    the wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dgvit_tpu_torch.ops import fused_preprocess as fp

    x = torch.rand((CAMERA_FRAMES, 512, 640), device=DEVICE) * 8.0
    fp.preprocess_depth_fused(x, SEED, 50.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(K5_PROFILED):
            fp.preprocess_depth_fused(x, SEED, 50.0)
        torch.cuda.synchronize()
    ours = ("minmax_kernel", "preprocess_kernel")
    counts = {next((n for n in ours if f"::{n}(" in e.key), e.key): e.count
              for e in prof.key_averages()
              if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    if not counts:
        print("K5's CUDA kernels: no device events recorded (not measured)",
              flush=True)
        return
    print(f"K5's CUDA kernels in {K5_PROFILED} calls of the wrapper "
          f"(torch.profiler): {counts}", flush=True)
    check(set(counts) == set(ours),
          f"K5's wrapper should launch minmax_kernel and preprocess_kernel "
          f"and nothing else, the profiler saw {counts}")

# --------------------------------------------------------------------------
# the attention slice: K6 (whole-trunk backward), K7 (attention section),
# K8 (attention), the trunk-gradient update and the composed routes
# --------------------------------------------------------------------------

K6_BATCHES = (1, 3, 8, 256)
K6_SMALL_N = 17            # a smaller token count (a 32x80 frame's)
# K6 against its plain version and against the chain of per-block kernels,
# per tensor as in phase 5, with L the plain tensor's largest |value|.
# fp32: another summation order through four blocks' recompute and
# backward; an H100 read up to 1.2e-4 L on the trained actor (its
# activations reach 1e4) and 1.7e-6 L on the seeded critic against the
# plain version, 2.9e-5 L against the chain: max |err| <= 1e-3 L.
# bf16: each tensor's max <= 2^-6 L, as in phase 5. The pooled mean cannot
# be phase 5's: K6 recomputes the stream, and where another summation
# order flips one bf16 rounding of x_i, every later block of that frame
# moves by an ulp. A tenth to a third of the frames of a large batch are
# touched, and a case pools anything from 7e-9 (B=1, no flip) to 8e-5
# where one block pools 3e-7: all cases pooled <= 2^-13 (read 2.3e-5).
# That limit cannot see a wrong rounding point (the two wrong backwards
# pool 6e-5 to 7e-5), so the sharp check is per frame: the mean of
# |err| / L over one frame's dx is next to nothing for a frame without a
# flip (K6's median frame read 5e-12) and about 1e-5 for the median frame
# of a wrong backward. Over the frames of all bf16 cases, two thirds must
# lie within phase 5's pooled limit 2^-18: an H100 read 88% of K6's
# frames within it and 48% of either wrong backward's.
K6_F32_MAX = 1e-3
K6_BF16_MEAN = 2.0 ** -13
K6_FRAMES_WITHIN = 2 / 3
# K7 and K8 against their plain versions: fp32 max |err| <= 1e-5 L; bf16
# max <= 2^-6 L and the pooled mean of |err| / L <= 2^-18 (phase 5's
# limits: the same rounding points, rare flips; an H100 read 7e-9 for K7;
# the bf16 K8, its probabilities split into bf16 hi + lo halves on the
# tensor cores, read 1.8e-7 on an H100 80GB HBM3 at 700 W, where its
# probabilities rounded to bf16 once fail, as tests/test_torch_attention.py
# shows). The backwards recompute the plain version, so they are held to
# the same limits against autograd of the plain version (read 0).
ATTN_SHAPES = ((256, 4, 65, 64), (64, 4, 257, 64), (8, 2, 65, 160))
SECTION_SHAPES = ((256, 65), (8, 256))          # (B, n) at d 64, 4 x 64
# The composed routes through the model. fp32, the sharp checks: the K7
# route against the same pass composed in PyTorch, means within 1e-4 L
# (read 2.1e-6 of 3.6) and every gradient within 1e-3 L (read 2.4e-5);
# the K8 route's actions within 1e-4 of the composition's (read 0) and of
# the fused K1 route's (read 2.6e-6: summation order and the erf
# polynomial). bf16: kernel and composition round at different points
# (K7 and K8 keep fp32 where the composition rounds every operation), and
# the trained actor's activations reach 1e4, so means agree to 2^-4 L
# (read 1.1e-2 to 1.7e-2 L) and actions to 2^-4 (read 1.3e-2); the
# composed and the fused bf16 models differ by their whole bf16 model
# error (the composed stream stays bf16, its GELU is the erf form):
# actions within 2^-2 (read 2.7e-2 and 7.0e-2 on two draws of frames).
COMPOSED_BF16, COMPOSED_FP32 = 2.0 ** -4, 1e-4
COMPOSED_BF16_VS_FUSED, COMPOSED_FP32_GRAD = 2.0 ** -2, 1e-3
# The fp32 trunk-gradient update against the default-route update from
# the same state: the same kernel bodies in another launch, the final
# norm's backward by hand instead of autograd; held to phase 6b's limits
# (an H100 read metrics equal, grads 2.3e-5 L, parameters 3.5e-4).


def trunk_autograd_bwd(x, dy, blocks, fn, heads, dim_head, final_norm):
    """A wrong bf16 trunk backward: autograd of K4's plain forward, which
    rounds gradients wherever the forward casts."""
    import torch

    from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain

    xr = x.detach().requires_grad_()
    wr = [[t.detach().requires_grad_() for t in w] for w in blocks]
    fr = [t.detach().requires_grad_() for t in fn]
    leaves = [xr, *[t for w in wr for t in w], *fr]
    gs = torch.autograd.grad(
        blocks_forward_plain(xr, wr, fr, heads, dim_head, final_norm),
        leaves, dy, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g
          for g, t in zip(gs, leaves)]
    n = 1 + 11 * len(blocks)
    return (gs[0], tuple(tuple(gs[i:i + 11]) for i in range(1, n, 11)),
            tuple(gs[n:]))


def trunk_fp32_dx_bwd(x, dy, blocks, fn, heads, dim_head, final_norm):
    """A wrong bf16 trunk backward: `trunk_bwd_plain`'s chain with dx
    handed from block to block in fp32 instead of the compute dtype. The
    block backwards return dx rounded, so the fp32 dx is put together from
    its parts: dy + the two LayerNorm backwards' input gradients, which a
    wrapper around `_ln_bwd` keeps."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops.trunk_train import final_norm_bwd_plain

    cdt = x.dtype
    xs = [x]
    for w in blocks[:-1]:
        xs.append(ft.block_plain(xs[-1].float(), w, heads=heads,
                                 dim_head=dim_head, cdt=cdt).to(cdt))
    cls = cb.cls_block_plain(xs[-1].float(), blocks[-1], heads=heads,
                             dim_head=dim_head, cdt=cdt).to(cdt).float()
    dcls, dfs, dfb = final_norm_bwd_plain(dy.float(), cls, fn[0], fn[1],
                                          final_norm)
    kept, real = [], ft._ln_bwd

    def keeping(*args):
        out = real(*args)
        kept.append(out[0])
        return out

    ft._ln_bwd = cb._ln_bwd = keeping
    try:
        dy_c = dcls.to(cdt)
        _, g = cb.cls_bwd_plain(xs[-1], dy_c, blocks[-1], heads, dim_head)
        dln2, dx32 = kept
        dx32 = dx32.clone()
        dx32[:, 0] += dy_c.float() + dln2
        grads = [g]
        for xi, w in zip(reversed(xs[:-1]), reversed(blocks[:-1])):
            del kept[:]
            _, g = ft.block_bwd_plain(xi, dx32, w, heads, dim_head)
            dx32 = dx32 + kept[0] + kept[1]
            grads.append(g)
    finally:
        ft._ln_bwd = cb._ln_bwd = real
    return dx32.to(cdt), tuple(reversed(grads)), (dfs, dfb)


def trunk_chain_bwd(x, dy, blocks, fn, heads, dim_head, final_norm):
    """The per-block kernels chained as the default route chains them:
    K2f, K3f forward, the final norm's backward in PyTorch, K3b, K2b."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops.trunk_train import final_norm_bwd_plain

    xs = [x]
    for w in blocks[:-1]:
        xs.append(ft.block_fwd_fused(xs[-1], w, heads, dim_head))
    cls = cb.cls_fwd_fused(xs[-1], blocks[-1], heads, dim_head)
    dcls, dfs, dfb = final_norm_bwd_plain(dy.float(), cls.float(), fn[0],
                                          fn[1], final_norm)
    dx, g = cb.cls_bwd_fused(xs[-1], dcls.to(x.dtype), blocks[-1], heads,
                             dim_head)
    grads = [g]
    for xi, w in zip(reversed(xs[:-1]), reversed(blocks[:-1])):
        dx, g = ft.block_bwd_fused(xi, dx, w, heads, dim_head)
        grads.append(g)
    return dx, tuple(reversed(grads)), (dfs, dfb)


def trunk_tensors(result):
    """dx, the blocks' 44 gradients and the final norm's, as one list; an
    all-zero bias gradient (RMS norm has none) is left out, the checks
    scale by a tensor's largest |value|."""
    dx, gblocks, dfn = result
    dfn = [g for g in dfn if g.abs().max().item() > 0]
    return [dx, *[g for gb in gblocks for g in gb], *dfn]


def k6_cases(nets, dtype, batch, rng):
    """(label, arguments of trunk_bwd_fused): the actor's trunk with its
    RMS norm, the critic's with a Layer norm of seeded bias, and at B=3
    the actor's on a smaller token count."""
    import torch

    inp = train_inputs(nets[dtype], batch, rng)
    a, c = inp["actor"], inp["critic"]
    bias = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(
        "float32")).to(DEVICE)
    cases = [
        ("actor rms n=65", (a["x"], a["dy3"], a["blocks"], a["fn"],
                            a["heads"], a["dh"], "rms")),
        ("critic layer n=65", (c["x"], c["dy3"], c["blocks"],
                               (c["fn"][0], bias), c["heads"], c["dh"],
                               "layer"))]
    if batch == 3:
        cases.append((f"actor rms n={K6_SMALL_N}", (
            a["x"][:, :K6_SMALL_N].contiguous(), a["dy3"], a["blocks"],
            a["fn"], a["heads"], a["dh"], "rms")))
    return cases


def phase_k6(nets, rng):
    """Phase 13: K6 against its plain version, against two wrong
    backwards, and against the chain of per-block kernels."""
    import torch

    from dgvit_tpu_torch.ops.trunk_train import (trunk_bwd_fused,
                                                 trunk_bwd_plain)

    wrongs = {"autograd of the plain forward": trunk_autograd_bwd,
              "dx kept in fp32 between blocks": trunk_fp32_dx_bwd}
    pooled = {name: TrainErrors() for name in ("K6", "chain", *wrongs)}
    frames = {name: [] for name in ("K6", *wrongs)}

    def frame_errs(dx, ref):
        scale = ref.float().abs().max().clamp(min=1e-30)
        return ((dx.float() - ref.float()).abs().mean(dim=(1, 2))
                / scale).tolist()

    worst = {}
    for dtype in ("float32", "bfloat16"):
        for batch in K6_BATCHES:
            for label, args in k6_cases(nets, dtype, batch, rng):
                out = trunk_tensors(trunk_bwd_fused(*args))
                torch.cuda.synchronize()
                ref = trunk_tensors(trunk_bwd_plain(*args))
                chain = trunk_tensors(trunk_chain_bwd(*args))
                what = f"K6 {dtype} B={batch} {label}"
                check(len(out) == len(ref) == len(chain) and all(
                    o.shape == r.shape and o.dtype == r.dtype
                    for o, r in zip(out, ref)), f"{what}: shapes or dtypes")
                check(all(bool(torch.isfinite(o.float()).all())
                          for o in out), f"{what}: non-finite")
                rel = lambda xs, ys: max(
                    (x.float() - y.float()).abs().max().item()
                    / max(y.float().abs().max().item(), 1e-30)
                    for x, y in zip(xs, ys))
                mx = max((o.float() - r.float()).abs().max().item()
                         for o, r in zip(out, ref))
                worst[dtype] = max(worst.get(dtype, 0.0), mx)
                if dtype == "float32":
                    e, ec = rel(out, ref), rel(out, chain)
                    ok = e <= K6_F32_MAX and ec <= K6_F32_MAX
                    print(f"{what}: vs plain max|err|/L {e:.3e}, vs the "
                          f"K3b + K2b chain {ec:.3e} "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    check(ok, f"{what} disagrees with its plain version or "
                          "the per-block chain")
                    continue
                e, ec = TrainErrors(), TrainErrors()
                e.add(zip(out, ref))
                ec.add(zip(out, chain))
                pooled["K6"].add(zip(out, ref))
                pooled["chain"].add(zip(out, chain))
                frames["K6"] += frame_errs(out[0], ref[0])
                line = (f"{what}: vs plain max|err| {mx:.3e}, mean|err|/L "
                        f"{e.mean:.3e}; vs the K3b + K2b chain max|err|/L "
                        f"{rel(out, chain):.3e}")
                for name, wrong in wrongs.items():
                    w = TrainErrors()
                    bad = trunk_tensors(wrong(*args))
                    w.add(zip(bad, ref))
                    pooled[name].add(zip(bad, ref))
                    frames[name] += frame_errs(bad[0], ref[0])
                    line += f"; wrong ({name}) mean|err|/L {w.mean:.3e}"
                print(line, flush=True)
                check(e.max_ok and ec.max_ok, f"{what} disagrees with its "
                      "plain version or the per-block chain")
    for name, e in pooled.items():
        versus = ("K6 vs the K3b + K2b chain" if name == "chain" else
                  f"{name} vs K6's plain version")
        print(f"{versus}, bf16 cases pooled: mean|err|/L {e.mean:.3e} "
              f"(limit {K6_BF16_MEAN:.3e}), every max within 2^-6 L: "
              f"{e.max_ok}", flush=True)
        if name not in wrongs:
            check(e.max_ok and e.mean <= K6_BF16_MEAN,
                  f"{versus}: they disagree (bf16 pooled)")
    for name, errs in frames.items():
        within = sum(e <= TRAIN_BF16_MEAN for e in errs) / len(errs)
        ok = within >= K6_FRAMES_WITHIN
        print(f"{name} vs K6's plain version, dx by frame over the bf16 "
              f"cases ({len(errs)} frames): median mean|err|/L "
              f"{statistics.median(errs):.3e}, frames within "
              f"{TRAIN_BF16_MEAN:.3e}: {within:.3f} (at least "
              f"{K6_FRAMES_WITHIN:.3f}); {'passes' if ok else 'FAILS'}",
              flush=True)
        if name in wrongs:
            check(not ok, f"K6's bf16 limits pass a wrong backward ({name})")
        else:
            check(ok, "K6 disagrees with its plain version (bf16, dx by "
                  "frame)")
    return worst


def phase_trunk_grad_fp32(default_run):
    """Phase 14b: one fp32 update on the trunk-gradient route through the
    kernels against the same update through the plain versions on the
    card, and against the default-route update from the same state."""
    import numpy as np

    g = np.load(GOLDEN_SAC)
    counters = kernel_counters()
    with trunk_grad_switch():
        before = {k: fn.launches for k, fn in counters.items()}
        kern = golden_update(DEVICE, g)
        check(all(counters[k].launches - before[k] == n
                  for k, n in PER_UPDATE_TRUNK.items()),
              "the fp32 trunk-gradient update did not go through K4 and K6")
        before = {k: fn.launches for k, fn in counters.items()}
        with plain_kernels():
            plain = golden_update(DEVICE, g)
        check(all(fn.launches == before[k] for k, fn in counters.items()),
              "the plain fp32 trunk-gradient update launched a kernel")
    worst = {}
    for name, ref in (("plain versions on the card", plain),
                      ("default-route update", default_run)):
        bad, rel = update_mismatches(kern, ref)
        gerr = max(((a - ref["grads"][n]).abs().max()
                    / ref["grads"][n].abs().max().clamp(min=1e-30)).item()
                   for n, a in kern["grads"].items())
        pmax = max((a - ref["params"][n]).abs().max().item()
                   for n, a in kern["params"].items())
        print(f"fp32 trunk-gradient update vs the {name}: largest relative "
              f"differences {rel}; grads max|err|/L {gerr:.3e}; parameters "
              f"max|diff| {pmax:.3e}", flush=True)
        check(not bad, f"the fp32 trunk-gradient update disagrees with the "
              f"{name}: {bad}")
        check(gerr <= SAC_RTOL, f"the fp32 trunk-gradient update's grads "
              f"disagree with the {name}")
        check(pmax <= 2.2e-3, f"the fp32 trunk-gradient update's parameters"
              f" disagree with the {name}")
        worst[name] = rel
    return worst


def pad_keys(t, multiple=8):
    """Zero rows appended to the token axis (-2) up to a multiple."""
    import torch.nn.functional as F

    return F.pad(t, (0, 0, 0, -t.shape[-2] % multiple))


def section_inputs(nets, dtype, batch, n, rng):
    """K7's arguments as the composed block hands them over: the actor's
    embedded stream of seeded frames through its first block's attention
    norm (for more than 65 tokens the stream repeated), and that block's
    projection weights, in a compute dtype."""
    import torch

    from dgvit_tpu_torch.ops.fused_transformer import _ln

    blk = nets[dtype]["actor"].trans.transformer.blocks[0]
    x = train_inputs(nets[dtype], batch, rng)["actor"]["x"]
    x = x.repeat(1, -(-n // x.shape[1]), 1)[:, :n]
    with torch.no_grad():
        h = _ln(x.float(), blk.attn_norm_scale, blk.attn_norm_bias).to(
            x.dtype).contiguous()
    return [h, *[getattr(blk, k).detach().to(x.dtype).contiguous()
                 for k in ("wqkv", "wout", "bout")]]


def phase_attention(nets, rng):
    """Phase 15: K7 and K8 against their plain versions, forward and
    backward, and wrong versions that must fail."""
    import torch

    from dgvit_tpu_torch.ops.attention import (attention_fused,
                                               attention_plain)
    from dgvit_tpu_torch.ops.fused_block import (attention_section_plain,
                                                 fused_attention_section)

    dev = torch.device(DEVICE)
    draw = lambda shape, dt: torch.from_numpy(rng.standard_normal(
        shape).astype("float32")).to(dev).to(dt)
    cases = []      # (kernel, label, dtype, fn, plain, args, wrongs)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for b, n in SECTION_SHAPES:
            x, *w = section_inputs(nets, dtype, b, n, rng)
            wrongs = {}
            if n % 8:
                wrongs["padded keys not masked"] = lambda x, *w: \
                    attention_section_plain(pad_keys(x), *w, 4, 64)[
                        :, :x.shape[1]]
            wrongs["scale 1 / dim_head"] = lambda x, wqkv, wout, bout: \
                attention_section_plain(
                    x, torch.cat([wqkv[:, :256] / 8, wqkv[:, 256:]], 1).to(
                        x.dtype), wout, bout, 4, 64)
            cases.append(("K7", f"({b}, {n}, 64)", dtype,
                          lambda *a: fused_attention_section(*a, 4, 64),
                          lambda *a: attention_section_plain(*a, 4, 64),
                          [x, *w], wrongs))
        for shape in ATTN_SHAPES:
            scale = shape[-1] ** -0.5
            args = [draw(shape, dt) for _ in range(3)]
            wrongs = {"scale 1 / D": lambda q, k, v, s=scale:
                      attention_plain(q, k, v, s * s)}
            if shape[2] % 8:
                wrongs["padded keys not masked"] = lambda q, k, v, s=scale: \
                    attention_plain(q, pad_keys(k), pad_keys(v), s)
            cases.append(("K8", str(shape), dtype,
                          lambda *a, s=scale: attention_fused(*a, s),
                          lambda *a, s=scale: attention_plain(*a, s),
                          args, wrongs))
    pooled = {k: TrainErrors() for k in ("K7", "K8")}
    pooled_bwd = {k: TrainErrors() for k in ("K7", "K8")}
    worst = {}
    for kernel, label, dtype, fn, plain, args, wrongs in cases:
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        check(out.shape == ref.shape and out.dtype == ref.dtype and
              bool(torch.isfinite(out.float()).all()),
              f"{kernel} {label} {dtype}: shape, dtype or non-finite")
        # the backward: the kernel route's recompute against autograd of
        # the plain version, on the same seeded output gradient
        dy = draw(tuple(out.shape), out.dtype)
        leaves = [t.detach().requires_grad_() for t in args]
        grads = torch.autograd.grad(fn(*leaves), leaves, dy)
        leaves = [t.detach().requires_grad_() for t in args]
        ref_grads = torch.autograd.grad(plain(*leaves), leaves, dy)
        scale = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        key = (kernel, dtype)
        worst[key] = max(worst.get(key, 0.0), err)
        gerr = max(((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30)).item()
                   for a, b in zip(grads, ref_grads))
        line = (f"{kernel} vs plain {dtype} {label}: max|err| {err:.3e} "
                f"(max|ref| {scale:.3e}), backward max|err|/L {gerr:.3e}")
        if dtype == "float32":
            ok = err <= TRAIN_F32_MAX * scale and gerr <= TRAIN_F32_MAX
            fails = lambda t: ((t.float() - ref.float()).abs().max().item()
                               > TRAIN_F32_MAX * scale)
        else:
            e, eb = TrainErrors(), TrainErrors()
            e.add([(out, ref)])
            eb.add(zip(grads, ref_grads))
            pooled[kernel].add([(out, ref)])
            pooled_bwd[kernel].add(zip(grads, ref_grads))
            ok = e.ok and eb.ok
            line += f", mean|err|/L {e.mean:.3e}"

            def fails(t):
                w = TrainErrors()
                w.add([(t, ref)])
                return not w.ok
        for name, wrong in wrongs.items():
            bad = wrong(*args)
            caught = fails(bad)
            line += (f"; wrong ({name}) max|err| "
                     f"{(bad.float() - ref.float()).abs().max().item():.3e}"
                     f" {'fails' if caught else 'PASSES'}")
            check(caught, f"{kernel}'s limits pass a wrong version "
                  f"({name}, {dtype} {label})")
        print(line + f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kernel} disagrees with its plain version "
              f"({dtype} {label})")
    for kernel in pooled:
        for what, e in (("forward", pooled[kernel]),
                        ("backward", pooled_bwd[kernel])):
            print(f"{kernel} {what} bf16 cases pooled: mean|err|/L "
                  f"{e.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}) "
                  f"{'ok' if e.ok else 'FAIL'}", flush=True)
            check(e.ok, f"{kernel} {what} disagrees (bf16 pooled)")
    return worst


def phase_composed(cfg, flat, policies, rng):
    """Phase 16, main paths: the composed routes through the model."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.models import (build_actor, layers,
                                        params_from_jax)
    from dgvit_tpu_torch.models.got import GoT

    dev = torch.device(DEVICE)
    counters = kernel_counters()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    def only(**want):
        return {k: want.get(k, 0) for k in counters}

    obs = torch.from_numpy(rng.uniform(0, 1, (SAC_BATCH, 128, 160)).astype(
        np.float32)).to(dev)
    goal = torch.from_numpy(np.stack(
        [rng.uniform(0, 1, SAC_BATCH), rng.uniform(-1, 1, SAC_BATCH)],
        axis=1).astype(np.float32)).to(dev)
    sd = params_from_jax(flat)
    launches = {}

    # (a) K7: the flagship actor with block dropout 0.1 in its GoT (no
    # config hands `dropout` on, in either package): a training forward
    # and backward at B=256, against the same pass with the section
    # composed in PyTorch (as on the CPU) and the same masks
    m = cfg.model
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        pol = build_actor(cfg, dtype=dt)
        pol.trans = GoT(image_size=tuple(m.image_size),
                        patch_size=tuple(m.patch_size), dim=m.latent_size,
                        depth=m.block, heads=m.head, dim_head=m.dim_head,
                        mlp_dim=m.mlp_dim, emb_dropout=m.emb_dropout,
                        dropout=0.1, dtype=dt)
        pol.load_state_dict(sd)
        pol = pol.to(dev).train()

        def train_pass():
            for p in pol.parameters():
                p.grad = None
            mean, log_std = pol(obs, goal, deterministic=False,
                                generator=torch.Generator(dev).manual_seed(
                                    SEED))
            (mean.float().square().mean()
             + log_std.float().mean()).backward()
            return mean.detach().float()

        mean, got = counted(train_pass)
        grads = {n: p.grad.detach().clone()
                 for n, p in pol.named_parameters()}
        check(got == only(K7=4),
              f"GoT(dropout=0.1) launched {got}, expected K7 x4")
        check(all(bool(torch.isfinite(g).all()) for g in grads.values())
              and all(g.abs().max().item() > 0 for n, g in grads.items()
                      if "trans" in n),
              "GoT(dropout=0.1): a parameter's gradient is missing or "
              "non-finite")
        on_card = layers._on_card
        layers._on_card = lambda t: False
        try:
            mean_ref, l_ref = counted(train_pass)
        finally:
            layers._on_card = on_card
        check(l_ref == only(), f"the composed reference launched {l_ref}")
        gerr, worst_name = max(
            (((p.grad - grads[n]).abs().max()
              / grads[n].abs().max().clamp(min=1e-30)).item(), n)
            for n, p in pol.named_parameters())
        scale = mean_ref.abs().max().item()
        err = (mean - mean_ref).abs().max().item()
        print(f"GoT(dropout=0.1) in the flagship policy, {dtype} "
              f"B={SAC_BATCH}, training forward and backward: launches "
              f"{got}; means vs the PyTorch composition {err:.3e} "
              f"(max|mean| {scale:.3e}), grads max|err|/L {gerr:.3e} "
              f"({worst_name})", flush=True)
        if dtype == "bfloat16":
            launches["dropout"] = got
            check(err <= COMPOSED_BF16 * scale,
                  "GoT(dropout=0.1), bf16: the K7 route's means leave the "
                  "composition's")
        else:
            check(err <= COMPOSED_FP32 * scale and gerr <= COMPOSED_FP32_GRAD,
                  "GoT(dropout=0.1), fp32: the K7 route leaves the "
                  "composition")

    # (b) K8 by name: build_actor(cfg, attn_impl="pallas"), deterministic
    # acting forward at B=256, against the same model composed in PyTorch
    # (attn_impl="xla") and against the K1 route with the same weights
    for dtype, limit, limit_k1 in (
            ("bfloat16", COMPOSED_BF16, COMPOSED_BF16_VS_FUSED),
            ("float32", COMPOSED_FP32, COMPOSED_FP32)):
        pols = {}
        for impl in ("pallas", "xla"):
            pols[impl] = build_actor(cfg, dtype=getattr(torch, dtype),
                                     attn_impl=impl)
            pols[impl].load_state_dict(sd)
            pols[impl] = pols[impl].to(dev).eval()
        with torch.no_grad():
            (mean, _), got = counted(lambda: pols["pallas"](
                obs, goal, inference=True))
            (comp, _), l_comp = counted(lambda: pols["xla"](
                obs, goal, inference=True))
            (ref, _), l_ref = counted(lambda: policies[dtype](
                obs, goal, inference=True))
        act = lambda t: torch.tanh(t.float())
        err = (act(mean) - act(comp)).abs().max().item()
        err_k1 = (act(mean) - act(ref)).abs().max().item()
        print(f"build_actor(attn_impl='pallas') {dtype} B={SAC_BATCH}, "
              f"acting forward: launches {got}; actions vs "
              f"attn_impl='xla' max|diff| {err:.3e} (limit {limit:.3e}), "
              f"vs the K1 route {err_k1:.3e} (limit {limit_k1:.3e})",
              flush=True)
        check(got == only(K8=4) and l_comp == only()
              and l_ref == only(K1=1),
              f"attn_impl='pallas' launched {got}, 'xla' {l_comp}, the "
              f"default actor {l_ref}; expected K8 x4, nothing, K1 x1")
        check(err <= limit and err_k1 <= limit_k1,
              f"attn_impl='pallas' ({dtype}): actions leave the "
              "composition's or the K1 route's")
        if dtype == "bfloat16":
            launches["pallas"] = got

    # (c) K8 by shape: model.patch_size (8, 10) gives 257 tokens, over
    # every fused limit; auto picks the kernel on the card
    cfg257 = Config.from_dict({"model": {"patch_size": [8, 10]}})
    b = 64
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        pols = {}
        for impl in ("auto", "xla"):
            pols[impl] = build_actor(
                cfg257, dtype=dt, attn_impl=impl,
                generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        with torch.no_grad():
            (mean, _), got = counted(lambda: pols["auto"](
                obs[:b], goal[:b], inference=True))
            (ref, _), l_ref = counted(lambda: pols["xla"](
                obs[:b], goal[:b], inference=True))
        err = (mean.float() - ref.float()).abs().max().item()
        limit = COMPOSED_BF16 if dtype == "bfloat16" else COMPOSED_FP32
        print(f"patch_size (8, 10), 257 tokens, {dtype} B={b}, acting "
              f"forward: launches {got}; mean vs attn_impl='xla' "
              f"{err:.3e} (limit {limit:.3e}, max|mean| "
              f"{ref.float().abs().max().item():.3e})", flush=True)
        check(got == only(K8=4) and l_ref == only(),
              f"257 tokens launched {got} (xla: {l_ref}); expected K8 x4")
        check(bool(torch.isfinite(mean.float()).all()) and err <= limit,
              f"257 tokens ({dtype}): means leave the composition's")
        if dtype == "bfloat16":
            launches["auto_257"] = got
    return launches


# --------------------------------------------------------------------------
# long frames: the route rule of ops/smem.py
# --------------------------------------------------------------------------

LONG_TOKENS, LONG_BATCH = (90, 129, 256), 32
# GoT.forward's fused routes by the kernels each runs, and their launches
# in one call (a 4-block trunk)
LONG_ROUTES = {"acting": ("K1",), "learn forward": ("K4",),
               "gradient": ("K2f", "K2b", "K3f", "K3b"),
               "trunk gradient": ("K4", "K6")}
LONG_FUSED = {"acting": {"K1": 1}, "learn forward": {"K4": 1},
              "gradient": {"K2f": 3, "K2b": 3, "K3f": 1, "K3b": 1},
              "trunk gradient": {"K4": 1, "K6": 1}}


@contextlib.contextmanager
def no_smem_limit():
    """The route rule with no shared-memory limit: every fused route."""
    from dgvit_tpu_torch.ops import smem

    limit_for = smem.limit_for
    smem.limit_for = lambda device: None
    try:
        yield
    finally:
        smem.limit_for = limit_for


def long_got(trunk, n, dtype, trunk_grad):
    """The trained actor's trunk on a strip of n - 1 patches of 16x20 (a
    (16, 20 (n - 1)) frame), its positional embedding tiled to n tokens,
    as phase 5b stretches its frames."""
    import torch

    from dgvit_tpu_torch.models.got import GoT

    got = GoT(image_size=(16, 20 * (n - 1)), patch_size=(16, 20),
              dim=trunk.pos_embedding.shape[-1],
              depth=len(trunk.transformer.blocks), heads=trunk.heads,
              dim_head=trunk.dim_head,
              mlp_dim=trunk.transformer.blocks[0].w1.shape[1],
              final_norm=trunk.final_norm, emb_dropout=trunk.emb_dropout,
              trunk_grad=trunk_grad, dtype=getattr(torch, dtype))
    state = {k: v.detach().cpu() for k, v in trunk.state_dict().items()}
    pos = state["pos_embedding"]
    state["pos_embedding"] = pos.repeat(1, -(-n // pos.shape[1]), 1)[:, :n]
    got.load_state_dict(state)
    return got.to(DEVICE)


def long_call(got, route, img, tok, proj):
    """One call of a route: (the latent, {parameter: gradient}), the
    gradient of sum(latent * proj) for the gradient-bearing routes. The
    emb-dropout masks come from one seed."""
    import torch

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    if route in ("acting", "learn forward"):
        with torch.no_grad():
            return got(img, tok, inference=True, generator=gen,
                       deterministic=route == "acting"), {}
    for p in got.parameters():
        p.grad = None
    out = got(img, tok, deterministic=False, generator=gen)
    (out.float() * proj).sum().backward()
    return out.detach(), {k: p.grad.clone()
                          for k, p in got.named_parameters()}


def long_design(route, n, dtype, dims, depth):
    """The route a call takes under the rule, and its launches: the fused
    route where its kernels hold the frame, else the per-block kernels
    where they hold it, else the composed blocks (K7 a block)."""
    import torch

    from dgvit_tpu_torch.ops import smem

    fits = lambda ks: smem.route_fits(ks, n, *dims, getattr(torch, dtype),
                                      torch.device(DEVICE))
    if fits(LONG_ROUTES[route]):
        return route, LONG_FUSED[route]
    per_block = ("gradient" if route in ("gradient", "trunk gradient")
                 else None)
    if per_block and fits(LONG_ROUTES[per_block]):
        return per_block, LONG_FUSED[per_block]
    if not per_block and fits(("K2f", "K3f")):
        return "per-block forward", {"K2f": depth - 1, "K3f": 1}
    return "composed", {"K7": depth}


def smem_mirror_mismatches():
    """Phase 17b (a): every byte count of ops/smem.py against the
    libraries' own queries, at 65, 90, 129 and 256 tokens, fp32 and bf16,
    the flagship widths and 2 x 32 heads with a 256-wide MLP."""
    import torch

    from dgvit_tpu_torch.ops import smem
    from dgvit_tpu_torch.ops.attention import _attention_lib
    from dgvit_tpu_torch.ops.fused_transformer import _block_lib
    from dgvit_tpu_torch.ops.got_megakernel import _kernel_lib

    g, b, a = _kernel_lib(), _block_lib(), _attention_lib()
    bad, count = [], 0
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for n in (65, *LONG_TOKENS):
            for d, heads, dh, mlp in ((64, 4, 64, 2048), (64, 2, 32, 256)):
                w = (n, d, heads, dh, mlp)
                fma = smem.fwd_fma(n, d, heads, dh, mlp, dtype)
                pairs = [
                    ("K1/K4", fma, g.got_forward_smem(code, *w, 0)),
                    ("K4 mma", smem.fwd_mma(n),
                     g.got_forward_smem(code, *w, 1)),
                    ("K2f", fma, b.block_forward_smem(code, 0, *w, 0)),
                    ("K2f mma", smem.fwd_mma(n),
                     b.block_forward_smem(code, 0, *w, 1)),
                    ("K3f", fma, b.block_forward_smem(code, 1, *w, 0)),
                    ("K2b", smem.bwd_fma(n, d, mlp),
                     b.block_backward_smem(code, 0, *w, 0)),
                    ("K2b mma", smem.bwd_mma(n),
                     b.block_backward_smem(code, 0, *w, 1)),
                    ("K3b", smem.bwd_fma(n, d, mlp),
                     b.block_backward_smem(code, 1, *w, 0)),
                    ("K3b mma", smem.bwd_cls_mma(n, heads, dh, mlp),
                     b.block_backward_smem(code, 1, *w, 1)),
                    ("K6", smem.trunk_bwd(*w, dtype, False),
                     b.trunk_backward_smem(code, *w, 0)),
                    ("K6 mma", smem.trunk_bwd(*w, dtype, True),
                     b.trunk_backward_smem(code, *w, 1)),
                    ("K7 one row", smem.section(n, d, dh, 1, dtype),
                     a.attention_section_smem(code, n, d, dh, 1)),
                    ("K7 every row", smem.section(n, d, dh, n, dtype),
                     a.attention_section_smem(code, n, d, dh, n))]
                count += len(pairs)
                bad += [(what, str(dtype), w, py, lib)
                        for what, py, lib in pairs if py != lib]
    return count, bad


def phase_long_frames(flat, rng):
    """Phase 17b: frames of 90, 129 and 256 tokens through every route of
    the model, fp32 and bf16. Each call takes the route ops/smem.py picks
    (a fused route where its kernels hold the frame, else the composed
    blocks), launches what that route launches and nothing raises; its
    latent and gradients are held against the plain version of the same
    route on the same card (the kernels swapped for their plain versions:
    K7's too on the composed route) within phase 5's limits (latents) and
    phase 13's (gradients, chained through four blocks). Returns the
    routes taken and, at 129 tokens in bf16, how far the composed
    gradient route's latents sit from the fused plain chain."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.models import build_actor, params_from_jax

    count, bad = smem_mirror_mismatches()
    print(f"shared-memory bytes, ops/smem.py against the libraries' "
          f"queries: {count} counts, {len(bad)} mismatches {bad}",
          flush=True)
    check(not bad, f"ops/smem.py disagrees with the libraries: {bad}")

    actor = build_actor(Config(), dtype=torch.float32)
    actor.load_state_dict(params_from_jax(flat))
    trunk = actor.trans
    b, dev = LONG_BATCH, torch.device(DEVICE)
    with torch.no_grad():
        tok = actor.fc_embed(torch.from_numpy(rng.uniform(
            -1, 1, (b, 2)).astype(np.float32))).to(dev)
    proj = torch.from_numpy(rng.standard_normal((b, 64)).astype(
        np.float32)).to(dev)
    dims = (trunk.pos_embedding.shape[-1], trunk.heads, trunk.dim_head,
            trunk.transformer.blocks[0].w1.shape[1])
    depth = len(trunk.transformer.blocks)
    counters = kernel_counters()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()
                     if c.launches}

    out_errs = {r: TrainErrors() for r in LONG_ROUTES}
    grad_errs = {r: TrainErrors() for r in LONG_ROUTES}
    taken, composed_vs_fused = {}, None
    for dtype in ("bfloat16", "float32"):
        for n in LONG_TOKENS:
            img = torch.from_numpy(rng.uniform(
                0, 1, (b, 16, 20 * (n - 1))).astype(np.float32)).to(dev)
            models = {tg: long_got(trunk, n, dtype, tg)
                      for tg in (False, True)}
            for route in LONG_ROUTES:
                got = models[route == "trunk gradient"]
                label, want = long_design(route, n, dtype, dims, depth)
                (out, grads), seen = counted(
                    lambda: long_call(got, route, img, tok, proj))
                check(seen == want, f"{n} tokens {dtype} {route}: launched "
                      f"{seen}, the route rule designed {want}")
                with plain_kernels():
                    (ref, ref_grads), none = counted(
                        lambda: long_call(got, route, img, tok, proj))
                check(not none, f"the plain {route} route launched {none}")
                check(bool(torch.isfinite(out.float()).all())
                      and all(bool(torch.isfinite(g).all())
                              for g in grads.values()),
                      f"{n} tokens {dtype} {route}: non-finite values")
                pairs = [(grads[k], ref_grads[k]) for k in grads]
                if dtype == "float32":
                    e_out = (out - ref).abs().max().item() / max(
                        ref.abs().max().item(), 1e-30)
                    e_grad = max([(g - r).abs().max().item() / max(
                        r.abs().max().item(), 1e-30) for g, r in pairs],
                        default=0.0)
                    ok = e_out <= TRAIN_F32_MAX and e_grad <= K6_F32_MAX
                    stats = (f"latent max|err|/L {e_out:.3e} (limit "
                             f"{TRAIN_F32_MAX:.0e}), grads max|err|/L "
                             f"{e_grad:.3e} (limit {K6_F32_MAX:.0e})")
                else:
                    e_o, e_g = TrainErrors(), TrainErrors()
                    e_o.add([(out, ref)])
                    e_g.add(pairs)
                    out_errs[route].add([(out, ref)])
                    grad_errs[route].add(pairs)
                    ok = e_o.max_ok and e_g.max_ok
                    stats = (f"latent mean|err|/L {e_o.mean:.3e}, grads "
                             f"mean|err|/L "
                             f"{e_g.mean if pairs else 0.0:.3e}, every max "
                             f"within 2^-6 L: {ok}")
                taken[f"{n} {dtype} {route}"] = label
                print(f"long frames, {n} tokens, {dtype}, {route}: route "
                      f"{label}, launches {seen}; vs the plain route: "
                      f"{stats} {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"{n} tokens {dtype} {route}: the {label} route "
                      "disagrees with its plain version")
                if (n, dtype, route) == (129, "bfloat16", "gradient"):
                    with plain_kernels(), no_smem_limit():
                        fused, _ = long_call(got, route, img, tok, proj)
                    e = TrainErrors()
                    e.add([(out, fused)])
                    composed_vs_fused = {"max_abs": e.worst,
                                         "pooled_mean_rel": e.mean,
                                         "route": label}
                    print(f"  129 tokens bf16, the {label} gradient route "
                          f"against the fused plain chain (K2/K3's plain "
                          f"versions): latent max|err| {e.worst:.3e}, "
                          f"mean|err|/L {e.mean:.3e} (a record, not a "
                          "check)", flush=True)
    for route in LONG_ROUTES:
        eo, eg = out_errs[route], grad_errs[route]
        ok = (eo.mean <= TRAIN_BF16_MEAN
              and (eg.count == 0 or eg.mean <= K6_BF16_MEAN))
        print(f"long frames, bf16 pooled, {route}: latent mean|err|/L "
              f"{eo.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}), grads "
              f"{eg.mean if eg.count else 0.0:.3e} (limit "
              f"{K6_BF16_MEAN:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"long frames, bf16 pooled, {route}: disagrees with the "
              "plain route")
    return {"routes": taken, "composed_vs_fused_129_bf16": composed_vs_fused}


def k6_work(batch, n=65, d=64, heads=4, dh=64, mlp=2048, depth=4, esize=2):
    """The least FLOPs and bytes of K4's backward from x and dy: the
    forward once (its activations are not given), two products for each
    of its products; x, dy and the weights read, dx and the weight
    gradients written, once each."""
    fwd, _ = train_work("K4", batch, n, d, heads, dh, mlp, depth, esize)
    inner = heads * dh
    w = d * 3 * inner + inner * d + 2 * d * mlp + mlp + 6 * d
    return 3 * fwd, ((2 * batch * n * d + batch * d + 2 * depth * w) * esize
                     + 4 * d * 4)


def k7_work(batch, n, d=64, heads=4, dh=64, esize=2):
    inner = heads * dh
    flops = batch * (2 * n * d * 3 * inner + 4 * heads * n * n * dh
                     + 2 * n * inner * d)
    return flops, (2 * batch * n * d + d * 3 * inner + inner * d + d) * esize


def k8_bound(shape, dtype):
    """K8's bound: q, k, v read and o written once; in bf16, q k^T as one
    tensor-core pass and P.V as two (the fp32 probabilities split into two
    bf16 halves, each multiplied by V), all at the bf16 rate; in fp32, both
    products at the fp32 rate. (Pricing bf16 P.V at the fp32 rate, as this
    bound once did, put a kernel that keeps fp32-accurate probabilities on
    the tensor cores above 100% of its bound.)"""
    b, h, n, d = shape
    half = 2 * b * h * n * n * d
    passes = 3 if dtype == "bfloat16" else 2
    t_ops = passes * half / PEAK_FLOPS[dtype]
    t_bytes = 4 * b * h * n * d * (2 if dtype == "bfloat16" else 4) \
        / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_attention_times(nets, rng):
    """Phase 17: K6, K7, K8 and their plain versions, bf16, beside their
    bounds and, for K8, scaled_dot_product_attention (both also by device
    time)."""
    import torch
    import torch.nn.functional as F

    from dgvit_tpu_torch.ops.attention import (attention_fused,
                                               attention_plain)
    from dgvit_tpu_torch.ops.fused_block import (attention_section_plain,
                                                 fused_attention_section)
    from dgvit_tpu_torch.ops.trunk_train import (trunk_bwd_fused,
                                                 trunk_bwd_plain)

    dev = torch.device(DEVICE)
    rows = {}
    a = train_inputs(nets["bfloat16"], SAC_BATCH, rng)["actor"]
    args = (a["x"], a["dy3"], a["blocks"], a["fn"], a["heads"], a["dh"],
            "rms")
    bnd, by = bound_ms(*k6_work(SAC_BATCH), "bfloat16")
    rows["K6"] = dict(ms=cuda_ms(lambda: trunk_bwd_fused(*args), 3, runs=5),
                      plain_ms=cuda_ms(lambda: trunk_bwd_plain(*args), 1,
                                       runs=5),
                      bound_ms=bnd, bound_by=by, library_ms=None)
    rows["K7"] = {}
    for b, n in SECTION_SHAPES:
        x, *w = section_inputs(nets, "bfloat16", b, n, rng)
        bnd, by = bound_ms(*k7_work(b, n), "bfloat16")
        rows["K7"][f"({b}, {n}, 64)"] = dict(
            ms=cuda_ms(lambda: fused_attention_section(x, *w, 4, 64), 10,
                       runs=5),
            plain_ms=cuda_ms(lambda: attention_section_plain(x, *w, 4, 64),
                             5, runs=5),
            bound_ms=bnd, bound_by=by, library_ms=None)
    rows["K8"] = {}
    for shape in ATTN_SHAPES:
        q, k, v = (torch.randn(shape, device=dev).bfloat16()
                   for _ in range(3))
        s = shape[-1] ** -0.5
        bnd, by = k8_bound(shape, "bfloat16")
        kern = lambda: attention_fused(q, k, v, s)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=s)
        rows["K8"][str(shape)] = dict(
            ms=cuda_ms(kern, 10, runs=5),
            plain_ms=cuda_ms(lambda: attention_plain(q, k, v, s), 5,
                             runs=5),
            bound_ms=bnd, bound_by=by, library_ms=cuda_ms(lib, 10, runs=5),
            device_ms=device_ms(kern), library_device_ms=device_ms(lib))
    before = {"K6": {f"B={SAC_BATCH}": FMA_DESIGN_MS["K6"]},
              "K8": FMA_DESIGN_MS["K8"]}
    for name, r in (("K6", {f"B={SAC_BATCH}": rows["K6"]}),
                    ("K7", rows["K7"]), ("K8", rows["K8"])):
        for label, t in r.items():
            lib = ("" if t["library_ms"] is None else
                   f", scaled_dot_product_attention {t['library_ms']:.4f} ms")
            was = before.get(name, {}).get(label)
            dev = ("" if "device_ms" not in t else
                   f"; device time (torch.profiler): kernel "
                   f"{t['device_ms']:.4f} ms, scaled_dot_product_attention "
                   f"{t['library_device_ms']:.4f} ms")
            print(f"{name} bf16 {label}: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']}){lib}"
                  + ("" if was is None else earlier(t["ms"], was)) + dev,
                  flush=True)
    return rows



# The times of the kernels redesigned for the tensor cores in their earlier
# FMA form (bf16; this script's phases 8 and 17 on an H100 80GB HBM3 at a
# 700 W power limit, recorded in PERF.md's kernel table): K2b and K6 at
# B=256, K4 and K2f at B=256, K3b at B=256, K8 by shape.
# Recorded, not measured in this run: they go on the printed lines only,
# never into the kernels line.
FMA_DESIGN_MS = {"K2b": 10.8233, "K6": 39.3067, "K4": 5.6300, "K2f": 1.6128,
                 "K3b": 1.9268,
                 "K8": {"(256, 4, 65, 64)": 0.2149,
                        "(64, 4, 257, 64)": 0.8475,
                        "(8, 2, 65, 160)": 0.0854}}


def earlier(t_ms, before_ms):
    """The earlier design's recorded time and the speed-up, for a printed
    line."""
    return (f"; earlier FMA design {before_ms:.4f} ms (recorded, not this "
            f"run), now {before_ms / t_ms:.2f}x faster")


KERNELS = {   # short name -> (wrapper, source, TPU kernel it replaces)
    "K1": ("got_forward_fused", "got_megakernel.cu",
           "dgvit_tpu/ops/got_megakernel.py:289"),
    "K4": ("blocks_cls_forward_fused", "got_megakernel.cu",
           "dgvit_tpu/ops/got_megakernel.py:208"),
    "K2f": ("block_fwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/fused_transformer.py:297"),
    "K2b": ("block_bwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/fused_transformer.py:568"),
    "K3f": ("cls_fwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/cls_block.py:281"),
    "K3b": ("cls_bwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/cls_block.py:320"),
    "K5": ("preprocess_depth_fused", "depth_preprocess.cu",
           "dgvit_tpu/ops/pallas_preprocess.py:205"),
    "K6": ("trunk_bwd_fused", "block_grad.cu",
           "dgvit_tpu/ops/trunk_train.py:150"),
    "K7": ("fused_attention_section", "attention.cu",
           "dgvit_tpu/ops/fused_block.py:79"),
    "K8": ("attention_fused", "attention.cu",
           "dgvit_tpu/ops/attention.py:80"),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / "dgvit_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.models import build_actor, params_from_jax
    from dgvit_tpu_torch.ops import _build
    from dgvit_tpu_torch.ops.attention import _attention_lib
    from dgvit_tpu_torch.ops.fused_preprocess import \
        _kernel_lib as _preprocess_lib
    from dgvit_tpu_torch.ops.fused_transformer import _block_lib
    from dgvit_tpu_torch.ops.got_megakernel import _kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off (torch.backends.cuda.matmul and cudnn)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)

    # the kernel libraries, and beside them (all eight nvcc at once) cubins
    # of the same sources whose ptxas reports give registers and spills
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = ("got_megakernel", "block_grad", "depth_preprocess",
               "attention")
    reports = [subprocess.Popen(
        [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR / f"{src}.cubin"),
         str(_build.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources]
    try:
        _build.build(*sources)
        _kernel_lib()
        _block_lib()
        _preprocess_lib()
        _attention_lib()
    finally:
        outs = [p.communicate()[0] for p in reports]
    print(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for proc, report in zip(reports, outs):
        check(proc.returncode == 0, f"ptxas report failed:\n{report}")
        for line in report.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas: {line.split()[-3][:100]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

    k5_cuda_kernels()
    cfg = Config()
    flat = load_params_npz(str(ACTOR))
    sd = params_from_jax(flat)
    policies = {}
    for dtype in ("bfloat16", "float32"):
        p = build_actor(cfg, dtype=getattr(torch, dtype))
        p.load_state_dict(sd)
        policies[dtype] = p.to(DEVICE).eval()
    rng = np.random.default_rng(SEED)

    worst = phase_kernel_vs_plain(cfg, policies, rng)
    act = phase_policy(cfg, flat)
    launches = phase_serving(act, rng)

    actor_flat, critic_flat = golden_params()
    nets = build_nets(actor_flat, critic_flat)
    train_worst = phase_train_kernels(nets, rng)
    phase_bwd_widths(nets, rng)
    wgrad_times = phase_weight_products()
    sac_launches, update_s, one_update = phase_sac(actor_flat, critic_flat)
    sac_fp32, default_fp32 = phase_sac_fp32()
    check_profile(phase_profile(one_update), DEFAULT_CUDA_LAUNCHES,
                  "default")

    k5_worst = phase_k5(rng)
    camera_launches = phase_camera(cfg, flat)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        loop_launches, loop_rates = phase_train(out_dir)

    k6_worst = phase_k6(nets, rng)
    with trunk_grad_switch():
        trunk_launches, trunk_update_s, trunk_update = phase_sac(
            actor_flat, critic_flat, PER_UPDATE_TRUNK,
            "trunk-gradient SAC")
    trunk_fp32 = phase_trunk_grad_fp32(default_fp32)
    check_profile(phase_profile(trunk_update, "trunk-gradient bf16"),
                  TRUNK_CUDA_LAUNCHES, "trunk-gradient")
    print(f"trunk-gradient route: {trunk_update_s * 1e3:.2f} ms an update "
          f"against {update_s * 1e3:.2f} ms on the default route (bf16, "
          f"B={SAC_BATCH}, host clock, synchronized, medians of steps 1-"
          f"{SAC_STEPS - 1} in this run)", flush=True)
    attn_worst = phase_attention(nets, rng)
    composed_launches = phase_composed(cfg, flat, policies, rng)

    times = phase_times(cfg, policies, rng)
    train_times = phase_train_times(nets, rng)
    k5_times = phase_k5_times(rng)
    attn_times = phase_attention_times(nets, rng)
    long_frames = phase_long_frames(flat, rng)

    main_b = 32  # the largest serving bucket: the serving path's biggest shape
    t = times[main_b]
    rows = [{
        "name": "got_forward_fused",
        "route": "cuda",
        "source": "dgvit_tpu_torch/ops/csrc/got_megakernel.cu",
        "replaces": KERNELS["K1"][2],
        "launches": launches,
        "max_abs_err": worst["bfloat16"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "batch": main_b,
        "dtype": "bfloat16",
        "max_abs_err_fp32": worst["float32"],
        "by_batch": {str(b): v for b, v in times.items()},
    }]
    rows[0]["launches_by_path"] = {
        "serving": launches, "camera_to_action": camera_launches["K1"],
        "train": loop_launches["K1"]}
    for short, (name, src, replaces) in KERNELS.items():
        if short in ("K4", "K2f", "K2b", "K3f", "K3b"):
            rows.append({
                "name": name, "route": "cuda",
                "source": f"dgvit_tpu_torch/ops/csrc/{src}",
                "replaces": replaces,
                "launches": sac_launches[short],
                "max_abs_err": train_worst[(short, "bfloat16")],
                **train_times[short],
                "library_ms": None,
                "batch": SAC_BATCH, "dtype": "bfloat16",
                "max_abs_err_fp32": train_worst[(short, "float32")],
                "launches_per_update": PER_UPDATE[short],
                **({"weight_products": wgrad_times} if short == "K2b"
                   else {}),
                "launches_by_path": {
                    "sac_update": sac_launches[short],
                    "train": loop_launches[short],
                    "trunk_grad_update": trunk_launches[short]},
            })
    name, src, replaces = KERNELS["K5"]
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": camera_launches["K5"], "max_abs_err": k5_worst,
        **k5_times[CAMERA_FRAMES], "library_ms": None,
        "batch": CAMERA_FRAMES, "dtype": "float32", "noise_level": 50.0,
        "by_batch": {str(b): v for b, v in k5_times.items()},
    })
    name, src, replaces = KERNELS["K6"]
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": trunk_launches["K6"],
        "max_abs_err": k6_worst["bfloat16"], **attn_times["K6"],
        "batch": SAC_BATCH, "dtype": "bfloat16",
        "max_abs_err_fp32": k6_worst["float32"],
        "launches_per_update": PER_UPDATE_TRUNK["K6"],
        "update_ms": trunk_update_s * 1e3,
        "default_update_ms": update_s * 1e3,
    })
    for short, path, shape in (
            ("K7", "dropout", f"({SAC_BATCH}, 65, 64)"),
            ("K8", "pallas", str(ATTN_SHAPES[0]))):
        name, src, replaces = KERNELS[short]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dgvit_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": composed_launches[path][short],
            "max_abs_err": attn_worst[(short, "bfloat16")],
            **attn_times[short][shape],
            "shape": shape, "dtype": "bfloat16",
            "max_abs_err_fp32": attn_worst[(short, "float32")],
            "launches_by_path": {k: v[short]
                                 for k, v in composed_launches.items()},
            "by_shape": attn_times[short],
        })
    print(f"fp32 trunk-gradient update, largest relative differences: "
          f"{json.dumps(trunk_fp32)}")
    print(f"long frames (phase 17b): {json.dumps(long_frames)}")
    print(f"train loop rates (bf16, B={SAC_BATCH}, host clock): "
          f"{json.dumps(loop_rates)}")
    print(f"SAC updates/s (bf16, B={SAC_BATCH}, host clock): "
          f"{1 / update_s:.3f}; fp32 update, largest relative differences: "
          f"{json.dumps(sac_fp32)}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
