#!/usr/bin/env python3
"""How far one SAC update's gradients lie from exact arithmetic on the
card: the fp32 (B=32) and bf16 (B=256) plain update of chip_smoke.py
phase 26's golden state and inputs, through the kernels, through their
plain versions, and through the plain versions with every product summed
in float64 (`chip_smoke.exact_sums`). Prints each pair's largest
max|err|/L over the gradient tensors (and which tensor) and their pooled
mean|err|/L. Phase 26's rule rests on these readings (chip_smoke.MESH_K).

    python3 chip_mesh_probe.py

Run from the root of a checkout on a host with a CUDA card and nvcc.
"""

import contextlib
import sys

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mesh_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from dgvit_tpu_torch.ops import _build

    _build.build("got_megakernel", "block_grad", "attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card(), torch.__version__, flush=True)
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
