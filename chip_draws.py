#!/usr/bin/env python3
"""Two checks of chip_smoke.py on draws that its full run does not make.

    python3 chip_draws.py TREE [TREE ...]

chip_smoke.py draws each phase's inputs from one generator started from
SEED, so what a phase draws depends on the phases run before it. For each
TREE (the root of a checkout, for example the parent commit unpacked with
`git archive` into a git-ignored directory, and the working tree), a
fresh Python process started in that tree builds its kernels and runs its
own chip_smoke.py phases 5 (the training kernels against their plain
versions) and 13 (K6) on two other orders of draws:

  shared: one generator from SEED through phases 5, 5b and 13;
  fresh:  phases 5 and 13 each on a generator of its own from SEED.

A failed check is printed (`CHECK FAILED: ...`) and the phase goes on.
For fp32 K2b at B=8 (phase 5) and bf16 K6 at B=256 on the actor's trunk
(phase 13) it prints each tensor's max |err| / L, L the largest |value|
of the plain version's tensor: K2b against its plain version on the card,
and that plain version against the same plain version on the CPU (fp32
sums in another order); K6 against its plain version, against the K3b +
K2b chain of per-block kernels, and the chain against the plain version.
Each run ends with one JSON line (`RESULT {...}`); the last line is a
table of the failed checks by run. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, os, sys
tree = sys.argv[1]
os.chdir(tree)
sys.path.insert(0, tree)
import numpy as np
import torch
import chip_smoke as cs
from dgvit_tpu_torch.ops import _build
from dgvit_tpu_torch.ops import fused_transformer as ft
from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_fused, trunk_bwd_plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build("got_megakernel", "block_grad")
NAMES = ("an_s", "an_b", "wqkv", "wout", "bout", "fn_s", "fn_b", "w1", "b1",
         "w2", "b2")
failed, stash = [], {}


def check(ok, what):
    if not ok:
        failed.append(what)
        print("CHECK FAILED: " + what, flush=True)


def stash_train(inp, cases=cs.train_cases):
    x = inp["actor"]["x"]
    if x.dtype == torch.float32 and x.shape[0] == 8:
        stash["K2b"] = inp["actor"]
    return cases(inp)


def stash_k6(nets, dtype, batch, rng, cases=cs.k6_cases):
    out = cases(nets, dtype, batch, rng)
    if dtype == "bfloat16" and batch == 256:
        stash["K6"] = dict(out)["actor rms n=65"]
    return out


cs.check, cs.train_cases, cs.k6_cases = check, stash_train, stash_k6


def rel(x, y):
    x, y = x.detach().float().cpu(), y.detach().float().cpu()
    return ((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()


def k2b_detail(a):
    args = (a["x"], a["dy2"], a["blocks"][0], a["heads"], a["dh"])
    cpu = (a["x"].cpu(), a["dy2"].cpu(), [t.cpu() for t in a["blocks"][0]],
           a["heads"], a["dh"])
    out = cs.tensors(ft.block_bwd_fused(*args))
    ref = cs.tensors(ft.block_bwd_plain(*args))
    host = cs.tensors(ft.block_bwd_plain(*cpu))
    rows = {}
    print("fp32 K2b B=8: tensor, L, max|err|/L kernel vs plain, plain on "
          "the card vs plain on the CPU (limit 1e-5)", flush=True)
    for name, o, r, h in zip(("dx", *NAMES), out, ref, host):
        rows[name] = [r.abs().max().item(), rel(o, r), rel(r, h)]
        print(f"  {name:5s} {rows[name][0]:.4e} {rows[name][1]:.3e} "
              f"{rows[name][2]:.3e}", flush=True)
    return rows


def k6_detail(args):
    def flat(res):
        dx, gb, dfn = res
        return [dx, *[g for b in gb for g in b], *dfn]

    names = (["dx"] + [f"blk{i}.{n}" for i in range(len(args[2]))
                       for n in NAMES] + ["final.fn_s", "final.fn_b"])
    out = flat(trunk_bwd_fused(*args))
    ref = flat(trunk_bwd_plain(*args))
    chain = flat(cs.trunk_chain_bwd(*args))
    rows = {n: [rel(o, r), rel(o, c), rel(c, r)]
            for n, o, r, c in zip(names, out, ref, chain)}
    print("bf16 K6 B=256 actor rms n=65: the 8 tensors farthest from the "
          "chain, max|err|/L of K6 vs plain, K6 vs the K3b + K2b chain, the "
          "chain vs plain (limit 2^-6 = 1.5625e-02)", flush=True)
    for n in sorted(rows, key=lambda n: -rows[n][1])[:8]:
        print(f"  {n:11s} {rows[n][0]:.3e} {rows[n][1]:.3e} "
              f"{rows[n][2]:.3e}", flush=True)
    return {n: rows[n] for n in sorted(rows, key=lambda n: -rows[n][1])[:8]}


actor_flat, critic_flat = cs.golden_params()
nets = cs.build_nets(actor_flat, critic_flat)
result = {}
for order in ("shared", "fresh"):
    failed.clear()
    stash.clear()
    rng = np.random.default_rng(cs.SEED)
    print(f"== {order}: phase 5", flush=True)
    cs.phase_train_kernels(nets, rng)
    if order == "shared":
        print(f"== {order}: phase 5b", flush=True)
        cs.phase_bwd_widths(nets, rng)
    else:
        rng = np.random.default_rng(cs.SEED)
    print(f"== {order}: phase 13", flush=True)
    cs.phase_k6(nets, rng)
    result[order] = {"failed": list(failed),
                     "K2b fp32 B=8": k2b_detail(stash["K2b"]),
                     "K6 bf16 B=256": k6_detail(stash["K6"])}
print("RESULT " + json.dumps(result), flush=True)
'''


def main() -> int:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    table = {}
    for i, tree in enumerate(trees):
        print(f"== run {i}: {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN, tree],
                              capture_output=True, text=True)
        print(proc.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads([ln for ln in proc.stdout.splitlines()
                             if ln.startswith("RESULT ")][-1][7:])
        table[f"{i}: {tree}"] = {k: v["failed"] for k, v in result.items()}
    print(json.dumps({"failed": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
