#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dgvit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card, nvcc and
nothing built: it builds the kernels itself (into build/kernels/), then

  1. device: prints the card's name and power limit (nvidia-smi);
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
  4. serving, the main path: a BatchingActorServer (buckets 1/8/16/32)
     answers 32 client threads x 4 requests; every answer equals the
     direct act for that row, and K1's launch count rose;
  5. times: K1 and its plain version at B in {1, 32, 64, 2048} (median of
     7 CUDA-event timings), beside the bound;

then prints one JSON line describing each kernel and, last, the device
line {"ok": true, "device": {...}}. Any failed check raises and ends the
run with a non-zero exit, before the last line. TF32 is switched off for
matmuls and cuDNN, so fp32 products of the plain version are full fp32.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def bound_ms(cfg, batch, dtype):
    flops, bytes_ = k1_work(cfg, batch, dtype)
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


def trunk_erf_gelu(*args):
    """A wrong bf16 trunk: the plain version with an erf GELU where the
    TPU kernel uses the tanh form."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain

    tanh_gelu = ft._gelu32
    ft._gelu32 = lambda x, cdt: 0.5 * x * (1.0 + torch.erf(
        x * ft._INV_SQRT2))
    try:
        return got_forward_plain(*args)
    finally:
        ft._gelu32 = tanh_gelu


def trunk_f32_residual(patches, goal, pe, pos, blocks, fn, heads, dim_head,
                       n_valid, final_norm):
    """A wrong bf16 trunk: the plain version with the residual stream kept
    in fp32 across blocks (no rounding after each block)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm

    cdt = patches.dtype
    emb = (ft._mm(patches, pe[0]) + pe[1].float()).to(cdt)
    x = torch.cat([goal[:, None, :], emb], dim=1)
    x32 = (x.float() + pos.float()[None]).to(cdt).float()
    for w in blocks[:-1]:
        x32 = ft.block_plain(x32, w, heads=heads, dim_head=dim_head, cdt=cdt)
    cls = gm._block_plain_cls(x32, blocks[-1], heads=heads,
                              dim_head=dim_head, cdt=cdt)
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
        lat = pol.trans(o, pol.fc_embed(gl)).cpu().numpy()
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
        bnd, by = bound_ms(cfg, batch, "bfloat16")
        rows[batch] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        print(f"K1 bf16 B={batch}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bnd:.5f} ms ({by}), "
              f"{batch / ms * 1e3:.0f} frames/s", flush=True)
    return rows


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

    # the kernel's library, and beside it (in parallel) a cubin of the same
    # source whose ptxas report gives registers and spills
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "got_megakernel.cu"
    ptxas = subprocess.Popen(
        [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR / "got_megakernel.cubin"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _kernel_lib()
    finally:
        report, _ = ptxas.communicate()
    print(f"built got_megakernel in {time.perf_counter() - t0:.1f} s")
    check(ptxas.returncode == 0, f"ptxas report failed:\n{report}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

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
    times = phase_times(cfg, policies, rng)

    main_b = 32  # the largest serving bucket: the main path's biggest shape
    t = times[main_b]
    print(json.dumps({"kernels": [{
        "name": "got_forward_fused",
        "route": "cuda",
        "source": "dgvit_tpu_torch/ops/csrc/got_megakernel.cu",
        "replaces": "dgvit_tpu/ops/got_megakernel.py:127",
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
