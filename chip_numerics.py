#!/usr/bin/env python3
"""How far K4's bf16 latent moves under other summation orders.

    python3 chip_numerics.py [SEED ...]          (default seeds 7 8 9 10)

Phase 5 of chip_smoke.py holds K4 (blocks_cls_forward_fused) to the
float64-sum version of its plain version (chip_smoke.exact_sums) by the
pooled mean of |err| / L over its bf16 latents at B = 1, 32 and 256,
within max(2^-18, EXACT_K["K4"] x the plain version's own distance). For
each seed this script draws such inputs (the trained actor's trunk on the
embedded stream of seeded frames, as phase 5 draws them) and prints,
pooled over the three batches:

  (a) the plain K4 with every product summed in float64 and rounded to
      fp32, against the plain K4: the statistic for sums more accurate
      than either side's, in another order;
  (b) on a card: the K4 kernel on the tensor-core body in its K4 form
      (K4's route), on the same body with every product on the tensor
      cores (no route takes it: the form K1 runs) and on the FMA body,
      each against the float64-sum version and under phase 5's restated
      limit (`passes` or `FAILS`);
  (c) on a card: the plain K4 with one kind of product at a time summed
      on the tensor cores (TF32, which holds bf16 operands exactly, so
      only the accumulation differs from the plain version's);
  (d) for one batch of 32 frames at 65 tokens and at phase 5b's 81: the
      pooled mean and, by frame, the share of frames whose latent is
      within 2^-18 (phase 13's rule), for the float64 sums of (a) and for
      two wrong versions (erf GELU, fp32 residual).

Runs on the card where there is one, else (a) alone on the CPU. Imports
torch, numpy and the port only.
"""

from __future__ import annotations

import functools
import sys

import chip_smoke as cs

KINDS = {(64, 768): "qkv", (64, 512): "qkv", (64, 256): "qkv",
         (256, 64): "out", (64, 2048): "pre", (2048, 64): "mlp"}


def patched(kinds):
    """_mm and _attention of the plain versions with the product kinds in
    `kinds` (a set) summed on TF32 tensor cores."""
    import torch

    def mm(a, b, kind):
        torch.backends.cuda.matmul.allow_tf32 = kind in kinds
        try:
            return a.float() @ b.float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def _mm(a, w):
        return mm(a, w, KINDS.get(tuple(w.shape)))

    def _attention(q, k, v, heads, dim_head, cdt):
        b, nq, _ = q.shape
        n = k.shape[1]
        split = lambda t, r: t.reshape(b, r, heads, dim_head).transpose(1, 2)
        s = mm(split(q, nq), split(k, n).transpose(-1, -2), "scores")
        s = s * dim_head ** -0.5
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (e / e.sum(dim=-1, keepdim=True)).to(cdt)
        o = mm(p, split(v, n), "pv").to(cdt)
        return o.transpose(1, 2).reshape(b, nq, heads * dim_head)
    return _mm, _attention


def main() -> int:
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm

    seeds = [int(s) for s in sys.argv[1:]] or [7, 8, 9, 10]
    card = torch.cuda.is_available()
    if not card:
        cs.DEVICE = "cpu"
        torch.set_num_threads(8)
    torch.backends.cuda.matmul.allow_tf32 = False
    nets = cs.build_nets(*cs.golden_params())
    plain = (ft._mm, ft._attention)
    tf32 = [("qkv",), ("scores",), ("pv",), ("out",), ("pre",), ("mlp",),
            ("qkv", "scores", "pv", "out", "pre", "mlp")]
    bodies = {"kernel, K4 form": None, "kernel, every product on the tensor "
              "cores": 2, "kernel, FMA body": 0}
    launch = gm._launch_blocks
    for seed in seeds:
        rng = np.random.default_rng(seed)
        runs = {}
        for b in (1, 32, 256):
            a = cs.train_inputs(nets["bfloat16"], b, rng)["actor"]
            args = (a["x"], a["blocks"], a["fn"], a["heads"], a["dh"], "rms")
            ref = gm.blocks_forward_plain(*args)
            ex = cs.exact(gm.blocks_forward_plain, *args)
            outs = {"float64 sums": ex}
            if card:
                for row, body in bodies.items():
                    gm._launch_blocks = functools.partial(launch, body=body)
                    try:
                        outs[row] = gm.blocks_cls_forward_fused(*args)
                    finally:
                        gm._launch_blocks = launch
                for kinds in tf32:
                    for mod in (ft, cb):
                        mod._mm, mod._attention = patched(set(kinds))
                    try:
                        outs[f"TF32 {'+'.join(kinds)}"] = \
                            gm.blocks_forward_plain(*args)
                    finally:
                        for mod in (ft, cb):
                            mod._mm, mod._attention = plain
            for row, out in outs.items():
                runs.setdefault(row, []).append((out, ref, ex))
        line = []
        for row, rs in runs.items():
            o, r, e = ([x[i] for x in rs] for i in range(3))
            if row == "float64 sums":
                line.append(f"{row} {cs.pooled_rel(o, r):.3e}")
                continue
            ok, got, limit = cs.restated(cs.pooled_rel, cs.TRAIN_BF16_MEAN,
                                         cs.EXACT_K["K4"], o, r, e)
            line.append(f"{row} {cs.pooled_rel(o, r):.3e}, against float64 "
                        f"sums {got:.3e} (limit {limit:.3e}, "
                        f"{'passes' if ok else 'FAILS'})")
        print(f"seed {seed}, K4 against its plain version, bf16 pooled over "
              f"B = 1, 32, 256, mean|err|/L: " + "; ".join(line), flush=True)
        a = cs.train_inputs(nets["bfloat16"], 32, rng)["actor"]
        x = a["x"]
        longer = torch.cat([x, x.roll(1, 0)[:, 1:1 + cs.EXTRA_TOKENS]],
                           dim=1).contiguous()
        for xs in (x, longer):
            args = (xs, a["blocks"], a["fn"], a["heads"], a["dh"], "rms")
            ref = gm.blocks_forward_plain(*args)
            outs = {"float64 sums": cs.exact(gm.blocks_forward_plain, *args)}
            outs["erf GELU"] = cs.k4_erf_gelu(*args)
            outs["fp32 residual"] = cs.k4_f32_residual(*args)
            line = []
            for what, out in outs.items():
                e = cs.TrainErrors()
                e.add([(out, ref)])
                line.append(f"{what} pooled {e.mean:.3e}, frames within "
                            f"{cs.latent_frames_within(out, ref):.3f}")
            print(f"seed {seed}, one batch of 32 at {xs.shape[1]} tokens: "
                  + "; ".join(line), flush=True)
    print(("on " + torch.cuda.get_device_name(0)) if card else "on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
