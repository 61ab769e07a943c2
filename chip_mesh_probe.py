#!/usr/bin/env python3
"""How far one SAC update's gradients lie from exact arithmetic on the
card: the fp32 (B=32) and bf16 (B=256) plain update of chip_smoke.py
phase 26's golden state and inputs, through the kernels, through their
plain versions, and through the plain versions with every product summed
in float64 (`chip_smoke.exact_sums`). Prints each pair's largest
max|err|/L over the gradient tensors (and which tensor) and their pooled
mean|err|/L. Phase 26's rule rests on these readings (chip_smoke.MESH_K).

    python3 chip_mesh_probe.py

With `--world N` it runs phase 26a's fp32 flavours at world N instead,
N gloo ranks on the first card (chip_smoke.MESH_W4_SPEC at that world):
each update beside the plain and the float64-sum N-rank versions from the
same state, every reading against its limit, the wrong data axes, and
lead x's verdict by flavour; a failed check is printed, not fatal, and
the exit code is 1 if any failed.

    python3 chip_mesh_probe.py --world 4

Run from the root of a checkout on a host with a CUDA card and nvcc.
"""

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs


def update_grads(dtype, plain=False, exact=False):
    """The actor's and critic's gradients of one plain update of phase
    26's state on its global inputs, in float64 on the host."""
    from dgvit_tpu_torch.agents import SACAgent

    spec = cs.MESH_SPEC
    agent = SACAgent(cs.mesh_cfg(spec, dtype), device="cuda",
                     seed=cs.MESH_SEED)
    state = cs.mesh_state(spec, agent)
    inp = cs.mesh_inputs(spec, dtype)
    batch = {k: torch.from_numpy(v).cuda() for k, v in inp["batch"].items()}
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(cs.plain_kernels())
        if exact:
            stack.enter_context(cs.exact_sums())
        state, _ = agent.learn(state, batch, noise=inp["noise"][0])
    return {f"{k}.{n}": p.grad.detach().double().cpu()
            for k in ("actor", "critic")
            for n, p in getattr(state, k).named_parameters()}


def reading(a, b):
    """The largest max|err|/L over the tensors (and its tensor), and the
    pooled mean|err|/L, of `a` against `b`."""
    rel = {n: ((a[n] - v).abs().max() / v.abs().max().clamp(min=1e-300)
               ).item() for n, v in b.items()}
    worst = max(rel, key=rel.get)
    e = cs.TrainErrors()
    e.add((a[n], v) for n, v in b.items())
    return f"max {rel[worst]:.3e} ({worst}), pooled {e.mean:.3e}"


def world_run(world: int) -> int:
    """Phase 26a's fp32 flavours at `world` gloo ranks of the first card,
    with the w-rank versions; the verdicts printed."""
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)
            print(f"CHECK FAILED: {what}", flush=True)

    cs.check = check
    spec = dict(cs.MESH_W4_SPEC, world=world)
    out = {"readings": {}, "launches": {}, "cluster_launches": {},
           "host_ms": {}, "lead_x": {}}
    with tempfile.TemporaryDirectory(prefix="chip_mesh_probe_") as tmp:
        ranks = cs.mesh_spawn("gloo", spec, Path(tmp), world)
    cs.mesh_verdicts(spec, f"gloo{world}", ranks, out)
    print(f"lead x at world {world} ({cs.card()}): "
          f"{json.dumps(out['lead_x'])}", flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=0,
                   help="run phase 26a's fp32 flavours at this many gloo "
                        "ranks of the first card instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_mesh_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from dgvit_tpu_torch.ops import _build

    _build.build("got_megakernel", "block_grad", "attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card(), torch.__version__, flush=True)
    if args.world:
        return world_run(args.world)
    for dtype in cs.MESH_SPEC["dtypes"]:
        g = {"kernels": update_grads(dtype),
             "plain": update_grads(dtype, plain=True),
             "float64 sums": update_grads(dtype, plain=True, exact=True)}
        for x, y in (("kernels", "plain"), ("kernels", "float64 sums"),
                     ("plain", "float64 sums")):
            print(f"{dtype} B={cs.MESH_SPEC['batch'][dtype]}: {x} against "
                  f"{y}: {reading(g[x], g[y])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
