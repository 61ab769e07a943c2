#!/usr/bin/env python3
"""fp32 K3f and K3b by batch in one or more checkouts of the port, in turns.

    python3 chip_k3_times.py TREE [TREE ...]

For each TREE in the order given (name a tree twice to run it twice: this
tree, that tree, that tree, this tree), a fresh Python process started in
that tree builds block_grad.cu and runs its own chip_smoke.py's
`k3_fp32_times` (phase 23a's timing of fp32 K3f and K3b) on the reference
configuration's GoT actor (4 heads x 64, MLP 2048) at K3_FP32_BATCHES, on
phase 23a's generator: the cluster form and the FMA body (forced), each
held to the plain version, their CUDA-event times beside the plain
version's and the bound, and the cluster form's device time by CUDA
kernel at K3_FP32_SPLIT. Each run prints one JSON line (`RESULT {...}`);
the last line is a table of the times by run. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, os, sys, tempfile
tree = sys.argv[1]
os.chdir(tree)
sys.path.insert(0, tree)
import numpy as np
import torch
import chip_smoke as cs
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import load_reference_yaml
from dgvit_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build("block_grad")
with tempfile.TemporaryDirectory() as tmp:
    cfg = load_reference_yaml(cs.reference_yaml(tmp))
actor = SACAgent(cfg, device="cuda", seed=cs.ZOO_SEED).init_state().actor
out = cs.k3_fp32_times(actor, np.random.default_rng(
    (cs.ZOO_SEED, cs.ZOO_BATCH, 3)))
print("RESULT " + json.dumps({"tree": tree, "card": cs.card(), **out}))
'''


def main() -> int:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]] or [
        str(Path(__file__).resolve().parent)]
    table = []
    for i, tree in enumerate(trees):
        print(f"== run {i}: {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN, tree],
                              capture_output=True, text=True)
        print(proc.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(next(ln[7:] for ln in proc.stdout.splitlines()
                              if ln.startswith("RESULT ")))
        table.append({"run": i, "tree": tree, "card": res["card"], **{
            f"{k} {b}": {"cluster_ms": v["cluster_ms"], "fma_ms": v["fma_ms"],
                         **({"cluster_device_ms": v["cluster_device_ms"]}
                            if "cluster_device_ms" in v else {})}
            for k in ("K3f", "K3b")
            for b, v in res[k]["by_batch"].items()}})
    print(json.dumps({"runs": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
