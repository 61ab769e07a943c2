#!/usr/bin/env python3
"""chip_smoke.py's restated checks on draws that its full run does not make.

    python3 chip_draws.py [--seeds 7 8 9 10 11] [--json PATH] [TREE ...]

chip_smoke.py draws each phase's inputs from one generator started from
SEED, so what a phase draws depends on the phases run before it. For each
TREE (the root of a checkout; by default the one this script is in) and
each seed, a fresh Python process started in that tree builds its kernels
and runs its own chip_smoke.py phases 2 (K1), 5 (the training kernels),
5b (the bodies off the flagship widths; "shared" only) and 13 (K6) on two
orders of draws:

  shared: one generator from the seed through phases 2, 5, 5b and 13;
  fresh:  phases 5 and 13 each on a generator of its own from the seed.

Phase 2 comes first in both orders, so its draws are the same in both;
it runs once a seed, with every form of K1 at every batch
(chip_smoke.K1_ALL_FORMS): the parent's FMA body beside the new ones.

A failed check is printed (`CHECK FAILED: ...`) and the phase goes on.
The four checks restated against float64 sums (chip_smoke.py, EXACT_K)
print one row per check, seed and order: the kernel, the plain version's
own distance to the float64-sum version that sets the limit, and each
wrong version, each against its limit (`ok` for the kernel, `fails` for a
wrong version, as the rule wants). The last line is a JSON table of the
failed checks by tree, seed and order; --json PATH also writes every raw
reading there. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, os, sys
tree, seeds = sys.argv[1], [int(s) for s in sys.argv[2].split(",")]
os.chdir(tree)
sys.path.insert(0, tree)
import numpy as np
import torch
import chip_smoke as cs
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import load_params_npz
from dgvit_tpu_torch.models import build_actor, params_from_jax
from dgvit_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build("got_megakernel", "block_grad")
failed = []


def check(ok, what):
    if not ok:
        failed.append(what)
        print("CHECK FAILED: " + what, flush=True)


cs.check = check
cs.K1_ALL_FORMS = True
cfg = Config()
sd = params_from_jax(load_params_npz(str(cs.ACTOR)))
policies = {}
for dtype in ("bfloat16", "float32"):
    p = build_actor(cfg, dtype=getattr(torch, dtype))
    p.load_state_dict(sd)
    policies[dtype] = p.to(cs.DEVICE).eval()
nets = cs.build_nets(*cs.golden_params())
for seed in seeds:
    for order in ("shared", "fresh"):
        failed.clear()
        cs.READINGS.clear()
        rng = np.random.default_rng(seed)
        fresh = lambda: rng if order == "shared" else np.random.default_rng(
            seed)
        if order == "shared":
            print(f"== seed {seed}: phase 2 (both orders)", flush=True)
            cs.phase_kernel_vs_plain(cfg, policies, rng)
        print(f"== seed {seed}, {order}: phase 5", flush=True)
        rng = fresh()
        cs.phase_train_kernels(nets, rng)
        if order == "shared":
            print(f"== seed {seed}, {order}: phase 5b", flush=True)
            cs.phase_bwd_widths(nets, rng)
        print(f"== seed {seed}, {order}: phase 13", flush=True)
        cs.phase_k6(nets, fresh())
        print("RESULT " + json.dumps({"seed": seed, "order": order,
                                      "failed": list(failed),
                                      "readings": cs.READINGS}), flush=True)
'''


def rows(result):
    """One printed row per restated check of one run."""
    tag = f"seed {result['seed']} {result['order']}"
    for r in result["readings"]:
        if r["check"] == "fp32 train":
            yield (f"{tag} fp32 {r['kernel']} B={r['batch']}: kernel "
                   f"{r['got']:.3e} against float64 sums (limit max(1e-5, "
                   f"{r['k']:g} x plain {r['plain']:.3e}) = {r['limit']:.3e};"
                   f" old vs plain {r['old']:.3e}) "
                   f"{'ok' if r['got'] <= r['limit'] else 'FAIL'}")
        elif r["check"] == "chain":
            yield (f"{tag} chain, dx frames within 2^-18 of float64 sums "
                   f"over {r['frames']} frames (at least {r['share']:g}): "
                   + ", ".join(
                       f"{n} {v:.3f} pooled {r['pooled'][n]:.3e} "
                       + ("" if n == "plain" else
                          ("ok" if r["verdict"][n] else "FAIL")
                          if n in ("chain", "K6") else
                          ("fails" if not r["verdict"][n] else "PASSES"))
                       for n, v in r["within"].items()))
            yield (f"{tag} chain, worst weight gradient against max(2^-6, "
                   "2 x plain): " + ", ".join(
                       f"{n} {w['got']:.3e}/{w['limit']:.3e} ({w['tensor']})"
                       for n, w in r["per_tensor"].items()))
            yield (f"{tag} chain, worst weight gradient's pooled mean against"
                   " max(2^-13, 2 x plain): " + ", ".join(
                       f"{n} {w['got']:.3e}/{w['limit']:.3e} ({w['tensor']})"
                       for n, w in r["tensor_mean"].items()))
        elif r["check"] == "K1 latent":
            for n, v in r["readings"].items():
                want = ("read only" if v.get("read_only") else
                        ("ok" if v["pass"] else "FAIL") if n.startswith("K1")
                        else ("fails" if not v["pass"] else "PASSES"))
                yield (f"{tag} {n} ({v['frames']} frames): mean "
                       f"{v['rel']:.3e}/{v['limit']:.3e} (plain "
                       f"{v['plain']:.3e}), max {v['max']:.3e}/"
                       f"{v['max_limit']:.3e} (plain {v['plain_max']:.3e}), "
                       f"failing alone {v['alone_fail']}/{v['launches']} "
                       f"(over the pooled limit "
                       f"{v['alone_over_pooled_limit']}) "
                       f"{want}")
        else:
            yield (f"{tag} {r['check']} (k {r['k']:g}, plain {r['plain']:.3e}"
                   "): " + ", ".join(
                       f"{n} {v['mean']:.3e}"
                       + (f"/{v['limit']:.3e}" if "limit" in v else "")
                       + ((" ok" if v["pass"] else " FAIL")
                          if n.startswith(("K1", "K4")) else
                          (" fails" if not v["pass"] else " PASSES"))
                       for n, v in r["readings"].items() if n != "plain"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[str(Path(__file__).parent)])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9, 10, 11])
    ap.add_argument("--json", help="write every raw reading here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    table, raw = {}, {}
    for i, tree in enumerate(str(Path(t).resolve()) for t in args.trees):
        print(f"== run {i}: {tree}", flush=True)
        proc = subprocess.run(
            [sys.executable, "-c", RUN, tree,
             ",".join(str(s) for s in args.seeds)],
            capture_output=True, text=True)
        print(proc.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        results = [json.loads(ln[7:]) for ln in proc.stdout.splitlines()
                   if ln.startswith("RESULT ")]
        for result in results:
            for row in rows(result):
                print(row, flush=True)
        key = f"{i}: {tree}"
        table[key] = {f"{r['seed']} {r['order']}": r["failed"]
                      for r in results}
        raw[key] = results
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(raw))
    print(json.dumps({"failed": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
