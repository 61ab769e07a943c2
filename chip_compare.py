#!/usr/bin/env python3
"""Time two or more checkouts of the port on one card, in turns.

    python3 chip_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and the working
tree). For each TREE in the order given (name a tree twice to run it
twice: parent, change, change, parent), a fresh Python process started in
that tree builds its kernels and runs its own chip_smoke.py phases: five
bf16 SAC updates at batch 256 on the default route and five on the
trunk-gradient route (host clock, medians of steps 1-4; then one more
update of each under torch.profiler, by the profiler helper of the
chip_smoke.py beside this script: its device time, in all and in the
weight products' kernels, `wgrad*`), phase 8's K1
times at each timed batch, phase 8b's training kernels, phase 12's K5
(and its device time by CUDA kernel at B = 1, 32 and 256, by the same
profiler helper) and phase 17's K6, K7 and K8 (CUDA events; where a
tree's chip_smoke.py times them, K3f's and K7's FMA kernels and K7's
library yardstick too). Each run prints one JSON line (`RESULT {...}`);
the last line is a table of every number by run. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import importlib.util, json, os, re, sys
tree = sys.argv[1]
# the profiler helper of the chip_smoke.py beside this script, the same
# for every tree (an older tree's chip_smoke.py may not have it)
spec = importlib.util.spec_from_file_location("own_smoke", sys.argv[2])
own = importlib.util.module_from_spec(spec)
spec.loader.exec_module(own)
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
_build.build("got_megakernel", "block_grad", "depth_preprocess",
             "attention")


def device_time(update, label):
    by = own.device_kernels_ms(update, calls=1)
    out[f"{label}_update_device_ms"] = sum(by.values())
    out[f"{label}_wgrad_device_ms"] = sum(t for k, t in by.items()
                                          if "wgrad" in k)


actor_flat, critic_flat = cs.golden_params()
out = {}
_, out["default_update_ms"], update = cs.phase_sac(actor_flat, critic_flat)
device_time(update, "default")
with cs.trunk_grad_switch():
    _, out["trunk_update_ms"], update = cs.phase_sac(
        actor_flat, critic_flat, cs.PER_UPDATE_TRUNK, "trunk-gradient SAC")
device_time(update, "trunk")
out["default_update_ms"] *= 1e3
out["trunk_update_ms"] *= 1e3
cfg = Config()
sd = params_from_jax(load_params_npz(str(cs.ACTOR)))
policies = {}
for dtype in ("bfloat16", "float32"):
    p = build_actor(cfg, dtype=getattr(torch, dtype))
    p.load_state_dict(sd)
    policies[dtype] = p.to(cs.DEVICE).eval()
rng = np.random.default_rng(cs.SEED)
nets = cs.build_nets(actor_flat, critic_flat)
for b, t in cs.phase_times(cfg, policies, rng).items():
    if isinstance(b, int):
        out[f"K1 (B={b})"] = t["ms"]
for name, t in cs.phase_train_times(nets, rng).items():
    out[name] = t["ms"]
    if "fma_ms" in t:
        out[f"{name} FMA kernel"] = t["fma_ms"]
for b, t in cs.phase_k5_times(rng).items():
    out[f"K5 (B={b})"] = t["ms"]
from dgvit_tpu_torch.ops import fused_preprocess as fp
for b in (1, 32, 256):   # K5's device time by CUDA kernel
    x = torch.rand((b, 512, 640), device=cs.DEVICE) * 8.0
    by = own.device_kernels_ms(
        lambda: fp.preprocess_depth_fused(x, cs.SEED, 50.0),
        calls=20 if b < 256 else 5)
    for key, t in by.items():   # the kernel's name, before its arguments
        name = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
        out[f"K5 (B={b}) device {name.group(1) if name else key}"] = t
attn = cs.phase_attention_times(nets, rng)
out["K6"] = attn["K6"]["ms"]
for name in ("K7", "K8"):
    for shape, t in attn[name].items():
        out[f"{name} {shape}"] = t["ms"]
        for key, what in (("fma_ms", "FMA kernel"),
                          ("yardstick_ms", "library yardstick")):
            if key in t:
                out[f"{name} {shape} {what}"] = t[key]
print("RESULT " + json.dumps(out), flush=True)
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
    smoke = str(Path(__file__).resolve().with_name("chip_smoke.py"))
    rows = []
    for i, tree in enumerate(trees):
        print(f"== run {i}: {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN, tree, smoke],
                              capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(line for line in lines
                        if "bf16 B=" in line or "RESULT" in line
                        or "median" in line), flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads([ln for ln in lines
                             if ln.startswith("RESULT ")][-1][7:])
        rows.append((i, tree, result))
    keys = list(dict.fromkeys(k for _, _, r in rows for k in r))
    table = {k: [r[2].get(k) for r in rows] for k in keys}
    print(json.dumps({"runs": [f"{i}: {t}" for i, t, _ in rows],
                      "ms": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
