#!/usr/bin/env python3
"""Where phase 5's fp32 K2b readings arise (gap r of ROADMAP.md).

    python3 chip_k2b_stages.py [--seeds 7 8 9 10 11] [--json PATH]
                               [--stages "8 shared B=1" "9 shared B=8"]

Phase 5 of chip_smoke.py held fp32 K2b (the cluster form at the flagship
widths) to the float64-sum version of its plain version: the largest
max|err|/L over dx and the 11 gradients within max(1e-5, 2 x the plain
version's own distance), which two of chip_draws.py's draws failed (gap
r; it is now held by the mean|err|/L pooled over the tensors and its two
batches against the float64 evaluation, `chip_smoke.f32_rule`). For each
seed and order of chip_draws.py's draws this script replays phase 5's
fp32 K2b inputs (B = 1 and 8; in the shared
order phase 2's draws are taken first, without running phase 2) and
prints that statistic for the cluster form, the FMA body (forced), the
plain version on the card and the float64-sum version, each against the
float64-sum version and against the plain version evaluated in float64
throughout (`chip_smoke.float64_eval`, the exact answer to the fp32
inputs), and the tensor each reads its largest error on.

For each draw named by --stages it splits LN1's bias gradient's error by
stage: the gradient computed in float64 from the version's own dpre, g1
and dqkv (read from its per-frame pass's workspace) on, against a float64
backward; a stage whose reading jumps is where the error arises. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402

NAMES = ("dx", *cs.GRAD_NAMES)


def run_bwd(x, dy, w, heads, dh, form):
    """K2b in `form` (0 the FMA body, 2 the fp32 cluster): (dx and the 11
    gradients, the per-frame pass's dpre, g1 and dqkv slots)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    b, n, d = x.shape
    mlp, inner = w[7].shape[-1], heads * dh
    lib = ft._block_lib()
    ws = torch.zeros(lib.block_backward_workspace(
        ft._DTYPES[x.dtype], 0, b, n, d, heads, dh, mlp), dtype=torch.uint8,
        device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in w]
    ft._call(lib.block_backward_launch, x.dtype, False,
             [x, dy, *w, dx, *grads, ws, None], x, heads, dh, mlp, form)
    torch.cuda.synchronize()
    # block_grad.cu's `workspace`: slots 0-10 in order, 16-byte aligned
    elems = (n * d, n * 3 * inner, n * inner, n * d, n * mlp, n * mlp,
             n * d, n * inner, n * 3 * inner)
    at, slots = 0, []
    for e in elems:
        slots.append(ws[at:at + 4 * b * e].view(torch.float32))
        at = (at + 4 * b * e + 15) // 16 * 16
    return [dx, *grads], {"dpre": slots[5].view(b, n, mlp),
                          "g1": slots[6].view(b, n, d),
                          "dqkv": slots[8].view(b, n, 3 * inner)}


def stages64(x, dy, w, heads, dh):
    """LN1's bias gradient of the block's float64 backward, and functions
    giving it in float64 from a given dpre, g1 or dqkv on."""
    import torch

    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = [
        t.double() for t in w]
    x, dy = x.double(), dy.double()
    b, n, d = x.shape
    inner, scale = heads * dh, dh ** -0.5

    def norm(t):
        m = t.mean(-1, keepdim=True)
        r = torch.rsqrt((t - m).square().mean(-1, keepdim=True) + 1e-5)
        return (t - m) * r, r

    def norm_bwd(g, xh, r, s):
        gs = g * s
        return r * (gs - gs.mean(-1, keepdim=True)
                    - xh * (gs * xh).mean(-1, keepdim=True))

    def erf(t):
        a = (0.254829592, -0.284496736, 1.421413741, -1.453152027,
             1.061405429)
        u = 1.0 / (1.0 + 0.3275911 * t.abs())
        poly = ((((a[4] * u + a[3]) * u + a[2]) * u + a[1]) * u + a[0]) * u
        return torch.sign(t) * (1.0 - poly * torch.exp(-t * t))

    heads_of = lambda t: t.reshape(b, n, heads, dh).transpose(1, 2)
    merge = lambda t: t.transpose(1, 2).reshape(b, n, inner)
    xh1, _ = norm(x)
    qkv = (xh1 * an_s + an_b) @ wqkv
    q, k, v = (heads_of(qkv[..., i * inner:(i + 1) * inner])
               for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    x1 = x + merge(p @ v) @ wout + bout
    xh2, r2 = norm(x1)
    pre = (xh2 * fn_s + fn_b) @ w1 + b1
    gelu_grad = (0.5 * (1 + erf(pre * 2 ** -0.5))
                 + pre * (2 * torch.pi) ** -0.5 * torch.exp(-0.5 * pre * pre))

    def from_dqkv(dqkv):
        return (dqkv.double() @ wqkv.t()).reshape(-1, d).sum(0)

    def from_g1(g1):
        do = heads_of(g1.double() @ wout.t())
        dp = do @ v.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
        return from_dqkv(torch.cat([merge(ds @ k),
                                    merge(ds.transpose(-1, -2) @ q),
                                    merge(p.transpose(-1, -2) @ do)], -1))

    def from_dpre(dpre):
        return from_g1(dy + norm_bwd(dpre.double() @ w1.t(), xh2, r2, fn_s))

    an_b_64 = from_dpre((dy @ w2.t()) * gelu_grad)
    return an_b_64, {"dpre": from_dpre, "g1": from_g1, "dqkv": from_dqkv}


def draws(seeds):
    """(label, K2b's arguments) of phase 5's fp32 inputs, as chip_draws.py
    draws them."""
    import numpy as np

    nets = cs.build_nets(*cs.golden_params())
    for seed in seeds:
        for order in ("shared", "fresh"):
            rng = np.random.default_rng(seed)
            if order == "shared":   # phase 2's draws (trunk_inputs)
                for bs in cs.CHECK_BATCHES.values():
                    for b in bs:
                        rng.uniform(0, 1, (b, 128, 160))
                        rng.uniform(-1, 1, (b, 2))
            for dtype, batches in cs.TRAIN_BATCHES.items():
                for b in batches:
                    inp = cs.train_inputs(nets[dtype], b, rng)
                    if dtype == "float32":
                        a = inp["actor"]
                        yield (f"{seed} {order} B={b}",
                               (a["x"], a["dy2"], a["blocks"][0],
                                a["heads"], a["dh"]))


def main() -> None:
    import torch

    from dgvit_tpu_torch.ops import _build
    from dgvit_tpu_torch.ops import fused_transformer as ft

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9, 10, 11])
    ap.add_argument("--stages", nargs="*",
                    default=["8 shared B=1", "9 shared B=8"])
    ap.add_argument("--json", help="write every reading here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_k2b_stages.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card(), flush=True)
    _build.build("block_grad")
    out = {}
    for label, a in draws(args.seeds):
        ex = cs.tensors(cs.exact(ft.block_bwd_plain, *a))
        f64 = cs.tensors(cs.float64_eval(ft.block_bwd_plain, *a))
        plain = cs.tensors(ft.block_bwd_plain(*a))
        cluster, c_slots = run_bwd(*a, 2)
        fma, f_slots = run_bwd(*a, 0)
        limit = max(cs.TRAIN_F32_MAX,
                    cs.EXACT_K["fp32"] * cs.rel_max(plain, ex))
        row = {"limit": limit}
        for name, v in (("cluster", cluster), ("FMA body", fma),
                        ("plain", plain), ("float64 sums", ex)):
            worst = max(range(len(v)), key=lambda i: cs.rel_max([v[i]],
                                                                [f64[i]]))
            row[name] = {"vs_sums": cs.rel_max(v, ex),
                         "vs_float64": cs.rel_max(v, f64),
                         "worst": NAMES[worst]}
        print(f"{label}: phase 5's limit {limit:.3e}; against float64 sums"
              " / against the float64 evaluation (worst tensor there): "
              + "; ".join(f"{n} {r['vs_sums']:.3e} / {r['vs_float64']:.3e} "
                          f"({r['worst']})" for n, r in row.items()
                          if n != "limit"), flush=True)
        if label in args.stages:
            an_b, from_stage = stages64(*a)
            rel = lambda t: ((t.double() - an_b).abs().max()
                             / an_b.abs().max()).item()
            row["an_b_stages"] = {"float64 sums": rel(ex[2]),
                                  "float64 evaluation": rel(f64[2])}
            for name, v, sl in (("cluster", cluster, c_slots),
                                ("FMA body", fma, f_slots)):
                row["an_b_stages"][name] = {
                    **{f"from {s}": rel(fn(sl[s]))
                       for s, fn in from_stage.items()},
                    "kernel": rel(v[2])}
            print(f"  LN1's bias gradient against the float64 backward: "
                  + json.dumps(row["an_b_stages"]), flush=True)
        out[label] = row
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
