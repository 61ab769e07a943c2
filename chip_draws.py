#!/usr/bin/env python3
"""chip_smoke.py's restated checks on draws that its full run does not make.

    python3 chip_draws.py [--seeds 7 8 9 10 11] [--json PATH]
                          [--phases 2 15 23b ...] [TREE ...]

chip_smoke.py draws each phase's inputs from one generator started from
SEED, so what a phase draws depends on the phases run before it. For each
TREE (the root of a checkout; by default the one this script is in) and
each seed, a fresh Python process started in that tree builds its kernels
and runs its own chip_smoke.py phases 2 (K1), 5 (the training kernels),
5b (the bodies off the flagship widths; "shared" only), 13 (K6, fp32 and
bf16), 15 (K7 and K8), 16 (the composed routes), 17b (long frames), 13a
and 13b (fault j's magnitude, and the same question of K2b, K3b and K6:
fault k's magnitude without the CLS records and its repair with them) on
two orders of draws, and phase 19a (the batched env on the card against
the CPU's on the seed's randm32 worlds and records, and the ring on the
card against the CPU's on the seed's rows) and phase 20a (the device
PER on the card against its CPU version on priorities planted from the
seed, and 2^20 draws under the chi-square limit) once a seed, in the
shared order: they draw from the seed alone; phase 23b's K8 checks at
the SimpleViT's shapes (`vit_attention_checks`, on a spawned generator
after 13b); and phase 22a's fp32 BC gradient passes (`phase_bc_kernels`
without its times, on a spawned generator after 23b). --phases runs only
the phases named; a phase left out still takes the spawns it would take,
so the spawned phases (15 and after) draw as in the whole run. Orders of
draws:

  shared: one generator from the seed through phases 2, 5, 5b and 13;
          phases 15, 16, 17b, 13a and 13b each on a generator spawned off
          it (`Generator.spawn`, as phase 13's extra draws are), in that
          order, so that a phase added at the end moves no other phase's
          draw; then phase 16 again on the draw it had when phases 13a
          and 13b ran before it (the seed's sixth spawn), where two of its
          bf16 checks once failed (lead l);
  fresh:  phases 5, 13, 15, 16, 17b, 13a and 13b each on a generator of
          its own from the seed.

Phase 2 comes first in both orders, so its draws are the same in both;
it runs once a seed, with every form of K1 at every batch
(chip_smoke.K1_ALL_FORMS): the parent's FMA body beside the new ones.

A failed check is printed (`CHECK FAILED: ...`) and the phase goes on.
The checks held to float64 sums or read against them (chip_smoke.py,
EXACT_K) print one row per check, seed and order: the kernel, the plain
version's own distance to the float64-sum version that sets the limit, and
each wrong version, each against its limit (`ok` for the kernel, `fails`
for a wrong version, as the rule wants). The last line is a JSON table of
the failed checks by tree, seed and order; --json PATH also writes every
raw reading there. Needs one CUDA card.
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
phases = set(sys.argv[3].split(","))
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
_build.build("got_megakernel", "block_grad", "attention")
failed = []


def check(ok, what):
    if not ok:
        failed.append(what)
        print("CHECK FAILED: " + what, flush=True)


cs.check = check
cs.K1_ALL_FORMS = True
cfg = Config()
flat = load_params_npz(str(cs.ACTOR))
sd = params_from_jax(flat)
policies = {}
for dtype in ("bfloat16", "float32"):
    p = build_actor(cfg, dtype=getattr(torch, dtype))
    p.load_state_dict(sd)
    policies[dtype] = p.to(cs.DEVICE).eval()
nets = cs.build_nets(*cs.golden_params())
# phases 13a and 13b come last: a spawn moves the draws of every later
# spawn off the same generator
later = [("15", lambda r: cs.phase_attention(nets, r)),
         ("16", lambda r: cs.phase_composed(cfg, flat, policies, r)),
         ("17b", lambda r: cs.phase_long_frames(flat, r)),
         ("13a", lambda r: cs.phase_fault_j(nets, r)),
         ("13b", lambda r: cs.phase_recompute(nets, r)),
         ("23b", lambda r: cs.vit_attention_checks(r)),
         ("22a", lambda r: cs.phase_bc_kernels(r, timed=False))]
for seed in seeds:
    for order in ("shared", "fresh"):
        failed.clear()
        cs.READINGS.clear()
        rng = np.random.default_rng(seed)
        fresh = lambda: rng if order == "shared" else np.random.default_rng(
            seed)
        if order == "shared":
            for name, phase in (
                    ("2", lambda: cs.phase_kernel_vs_plain(cfg, policies,
                                                           rng)),
                    ("19a", lambda: cs.phase_vec_env(seed)),
                    ("20a", lambda: cs.phase_device_per(seed))):
                if name in phases:
                    print(f"== seed {seed}: phase {name} (both orders)",
                          flush=True)
                    phase()
        rng = fresh()
        if "5" in phases:
            print(f"== seed {seed}, {order}: phase 5", flush=True)
            cs.phase_train_kernels(nets, rng)
        # phases 5b and 13 spawn once each off the shared generator; left
        # out, they still take their spawn, so that the spawned phases
        # after them draw as in the whole run
        if order == "shared" and "5b" in phases:
            print(f"== seed {seed}, {order}: phase 5b", flush=True)
            cs.phase_bwd_widths(nets, rng)
        elif order == "shared":
            rng.spawn(1)
        if "13" in phases:
            print(f"== seed {seed}, {order}: phase 13", flush=True)
            cs.phase_k6(nets, fresh())
        elif order == "shared":
            rng.spawn(1)
        for name, phase in later:
            r = fresh().spawn(1)[0]  # taken whether the phase runs or not
            if name in phases:
                print(f"== seed {seed}, {order}: phase {name}", flush=True)
                phase(r)
        if order == "shared" and "16" in phases:
            # lead l: phase 16 on the generator it had in an earlier order,
            # where phases 13a and 13b were spawned before it (phases 5b
            # and 13 spawn once each): the seed's sixth spawn
            print(f"== seed {seed}, {order}: phase 16 on its earlier draw",
                  flush=True)
            cs.phase_composed(cfg, flat, policies,
                              np.random.default_rng(seed).spawn(6)[5])
        print("RESULT " + json.dumps({"seed": seed, "order": order,
                                      "failed": list(failed),
                                      "readings": cs.READINGS}), flush=True)
'''


PHASES = ["2", "19a", "20a", "5", "5b", "13", "15", "16", "17b", "13a",
          "13b", "23b", "22a"]


def rows(result):
    """One printed row per restated check of one run."""
    tag = f"seed {result['seed']} {result['order']}"
    verdict = lambda ok: "ok" if ok else "FAIL"
    for r in result["readings"]:
        if r["check"] == "fp32 train":
            at = "+".join(map(str, r.get("batches", [r.get("batch")])))
            maxes = lambda n: (" (max " + ", ".join(
                f"{m:.3e}" for m in r["max"][n]) + ")" if "max" in r else "")
            stat = ("mean|err|/L pooled" if r["stat"] == "pooled"
                    else "largest max|err|/L")
            yield (f"{tag} fp32 {r['kernel']} B={at}: {stat} "
                   f"against {r['against']} (limit max("
                   f"{r['floor']:.3e}, {r['k']:g} x plain "
                   f"{r['readings']['plain']:.3e}) = {r['limit']:.3e}): "
                   + ", ".join(
                       f"{n} {v:.3e}{maxes(n)} "
                       + (("fails" if not r["verdict"][n] else "PASSES")
                          if n in r.get("wrong", ()) else
                          ("ok" if r["verdict"].get(n, True) else "FAIL"))
                       for n, v in r["readings"].items()))
        elif r["check"] == "K2b bf16":
            yield (f"{tag} K2b bf16: dx frames within 2^-18 of float64 sums "
                   f"over {r['frames']} frames (at least {r['share']:g}) / "
                   f"every tensor pooled (limit {r['limit']:.3e}): "
                   + ", ".join(
                       f"{n} {v:.4f} / {r['pooled'][n]:.3e} " + (
                           ("ok" if r["verdict"][n] else "FAIL")
                           if n in ("K2b", "plain") else
                           ("fails" if not r["verdict"][n] else "PASSES"))
                       for n, v in r["within"].items())
                   + f"; old vs plain pooled {r['old']['mean']:.3e}, every "
                   f"max within 2^-6 L {r['old']['max_ok']}")
        elif r["check"] == "BC gradient pass fp32":
            yield (f"{tag} BC gradient pass fp32, {r['case']}: kernels "
                   f"{r['got']:.3e} against float64 sums (limit max(1e-5, "
                   f"{r['k']:g} x plain {r['plain']:.3e}) = {r['limit']:.3e})"
                   f" {verdict(r['pass'])}; tanh GELU {r['tanh_gelu']:.3e} "
                   + ("PASSES" if r["tanh_gelu_pass"] else "fails")
                   + f"; scores scaled 1 / dim_head {r['mis_scaled']:.3e} "
                   + ("PASSES" if r["mis_scaled_pass"] else "fails"))
        elif r["check"] == "K1 fp32 hidden":
            yield (f"{tag} K1 fp32 B={r['batch']}, the first block's MLP "
                   "hidden against float64 sums, pooled (limit "
                   f"{r['limit']:.3e}): "
                   + ", ".join(
                       f"{n} {v:.3e} " + (
                           ("ok" if v <= r["limit"] else "FAIL")
                           if n in ("K1's body", "float64 sums") else
                           "(plain)" if n == "plain" else
                           ("fails" if v > r["limit"] else "PASSES"))
                       for n, v in r["readings"].items()))
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
            yield (f"{tag} chain, on the batch's scale (a record): "
                   + ", ".join(f"{n} {v:.3f}"
                               for n, v in r["batch_scale"].items()))
            yield (f"{tag} chain, worst weight gradient against max(2^-6, "
                   "2 x plain): " + ", ".join(
                       f"{n} {w['got']:.3e}/{w['limit']:.3e} ({w['tensor']})"
                       for n, w in r["per_tensor"].items()))
            yield (f"{tag} chain, worst weight gradient's pooled mean against"
                   " max(2^-13, 2 x plain): " + ", ".join(
                       f"{n} {w['got']:.3e}/{w['limit']:.3e} ({w['tensor']})"
                       for n, w in r["tensor_mean"].items()))
        elif r["check"] == "fault j":
            for case, v in r.items():
                if not isinstance(v, dict):
                    continue
                yield (f"{tag} fault j {case}: frames with streams moved by "
                       "block " + ", ".join(f"{x:.4f}" for x in v["differ"])
                       + f", any {v['anywhere']:.4f}; K6 vs float64 sums: "
                       + ", ".join(
                           f"{n} pooled {k['pooled']:.3e}, dx max "
                           f"{k['dx_max']:.3e}, within batch "
                           f"{k['batch_scale']:.4f} own {k['own_scale']:.4f}"
                           for n, k in v["k6"].items()))
        elif r["check"] == "recompute":
            for case, v in r.items():
                if not isinstance(v, dict):
                    continue
                if case.startswith("anchors"):   # fault k's records
                    for name, a in v.items():
                        worst, lim = max(a["read"].values()), a["limit"]
                        yield (f"{tag} recompute {case}, {name}: the records"
                               f" against the forward's input and output, "
                               f"pooled {worst:.3e} (limit {lim:.3e}) "
                               + verdict(worst <= lim
                                         and all(x > lim for x in
                                                 a["planted"].values()))
                               + "".join(f"; planted {k} {x:.3e}"
                                         for k, x in a["planted"].items())
                               + "; a frame's largest "
                               f"{max(a['frame_max'].values()):.3e}")
                    continue
                line = (f"{tag} recompute {case}: frames differing "
                        + ", ".join(f"{k} {x:.4f}"
                                    for k, x in v["differ"].items())
                        + f", any {v['anywhere']:.4f}")
                if "after_differ" in v:   # K3b and K6: fault k
                    line += (
                        f" (with the records: {v['after_differ']:.4f}); dx "
                        "within 2^-18 of float64 sums (own scale) without "
                        f"the records where one differs "
                        f"{v['within_moved']:.4f}, where none "
                        f"{v['within_unmoved']:.4f}; with them "
                        f"{v['within_after']:.4f} "
                        + verdict(v["within_after"] >= 0.5
                                  and v["after_differ"] == 0)
                        + f"; pooled {v['pooled']:.3e} -> "
                        f"{v['pooled_after']:.3e}")
                if "kv_differ" in v:
                    line += f"; k|v differ {v['kv_differ']:.4f}"
                yield line
        elif r["check"] == "device PER":
            yield (f"{tag} device PER: state vs the CPU {r['state_rel']:.3e}"
                   f" (rtol 1e-6), weights {r['weights_rel']:.3e} (rtol "
                   f"1e-5), {r['moved_draws']} draws on a neighbour at a "
                   f"boundary; chi-square {r['chi2']:.1f} (limit "
                   f"{r['chi2_limit']:.1f}) "
                   + verdict(r["chi2"] <= r["chi2_limit"]
                             and r["empty_drawn"] == 0)
                   + f"; a uniform sampler {r['uniform_chi2']:.1f} "
                   + ("fails" if r["uniform_chi2"] > r["chi2_limit"]
                      else "PASSES")
                   + f"; a first-wins update {r['first_wins_rel']:.3e} "
                   + ("fails" if r["first_wins_rel"] > 1e-3 else "PASSES"))
        elif r["check"] == "composed":
            pooled, limit = r["pooled"], r["pooled_limit"]
            yield (f"{tag} {r['what']}: kernels vs float64 sums, pooled "
                   f"mean|err|/L {pooled['kernels']:.3e} (limit max(2^-18, "
                   f"2 x plain {pooled['plain']:.3e}) = {limit:.3e}) "
                   + verdict(pooled["kernels"] <= limit and r["masks"]
                             and r["kernels"] <= r["limit"])
                   + "".join(f"; {n} {pooled[n]:.3e} ({x:.3f} x the limit, "
                             + ("fails" if x > 1 else "PASSES") + ")"
                             for n, x in r["wrong"].items())
                   + f"; max|err| {r['kernels']:.3e} (limit max(2^-4, 2 x "
                   f"plain {r['plain']:.3e}) = {r['limit']:.3e})"
                   + f"; old vs the composition {r['old']:.3e} (limit "
                   f"6.250e-02) {verdict(r['old'] <= 0.0625)}; the "
                   f"composition vs float64 sums {r['composition']:.3e}, "
                   f"vs its own {r['composition_own']:.3e}; the two "
                   f"float64-sum versions apart {r['exact_apart']:.3e}; "
                   f"masks equal {r['masks']}; K7 vs plain on its inputs "
                   f"{r['k7_backward']:.3e}; by block, the frame the "
                   "composition moved most, vs float64 sums (kernels / "
                   "plain / composition): " + ", ".join(
                       f"{i}: {b['kernels']:.1e} / {b['plain']:.1e} / "
                       f"{b['composition']:.1e}"
                       for i, b in enumerate(r["by_block"])))
        elif r["check"] == "fp32 K6":
            yield (f"{tag} fp32 K6 {r['case']}: K6 {r['got']:.3e} against "
                   f"float64 sums (limit max(1e-3, {r['k']:g} x plain "
                   f"{r['plain']:.3e}) = {r['limit']:.3e}); the chain on its "
                   f"own streams {r['chain']:.3e} (limit "
                   f"{r['chain_limit']:.3e}, plain there "
                   f"{r['chain_plain']:.3e}), on K4's {r['chain_on_k4']:.3e}"
                   f" (read only); old vs plain {r['old']:.3e} "
                   + verdict(r["got"] <= r["limit"]
                             and r["chain"] <= r["chain_limit"]))
        elif r["check"] in ("K3f bf16", "K7 bf16"):
            yield (f"{tag} {r['check']} vs plain, pooled (limit "
                   f"{r['limit']:.3e}): " + ", ".join(
                       f"{n} {v['mean']:.3e} max {v['max_ok']} "
                       + (("ok" if v["pass"] else "FAIL")
                          if n in ("K3f", "K7", "float64 sums") else
                          ("fails" if not v["pass"] else "PASSES"))
                       for n, v in r["readings"].items()))
        elif r["check"] == "K6 widths":
            yield (f"{tag} K6 on the FMA bodies, dx frames within 2^-18 of "
                   f"float64 sums over {r['frames']} frames (at least "
                   f"{r['share']:g}): " + ", ".join(
                       f"{n} {v:.3f} " + ("" if n == "plain" else
                                          ("ok" if r["verdict"][n] else
                                           "FAIL") if n == "K6" else
                                          ("fails" if not r["verdict"][n]
                                           else "PASSES"))
                       for n, v in r["within"].items()))
            yield (f"{tag} K6 on the FMA bodies, on the batch's scale (a "
                   "record): " + ", ".join(
                       f"{n} {v:.3f}" for n, v in r["batch_scale"].items()))
            for case, shares in r["by_case"].items():
                yield (f"{tag} K6 on the FMA bodies, {case}: " + ", ".join(
                    f"{n} {v:.3f}" for n, v in shares.items()))
        elif r["check"] == "long frames":
            for route, v in r["routes"].items():
                yield (f"{tag} long frames {route}, pooled vs float64 sums "
                       f"(latent / grads, limits {v['limits'][0]:.3e} / "
                       f"{v['limits'][1]:.3e}): " + ", ".join(
                           f"{n} {x['latent']:.3e} / {x['grads']:.3e} "
                           + (("ok" if x["pass"] else "FAIL")
                              if n in ("kernels", "plain") else
                              ("fails" if not x["pass"] else "PASSES"))
                           for n, x in v["read"].items()))
            for n in {n for v in r["routes"].values() for n in v["read"]
                      if n.startswith("K7 with")}:
                worst = max(v["read"][n]["ratio"]
                            for v in r["routes"].values() if n in v["read"])
                yield (f"{tag} long frames, {n}: the largest reading over a "
                       f"route's limit {worst:.3f} "
                       + ("fails" if worst > 1 else "PASSES"))
            for c in r["calls"]:
                yield (f"{tag} long frames {c['call']}: max kernels "
                       f"{c['kernels']:.3e} / limit {c['limit']:.3e} "
                       f"(plain {c['plain']:.3e}) "
                       f"{'ok' if c['kernels'] <= c['limit'] else 'FAIL'}"
                       + "".join(f", {n} {v:.3e}" for n, v in c.items()
                                 if n.startswith("K7 with")))
        elif r["check"] == "vec env":
            yield (f"{tag} the batched env on the card vs the CPU: images "
                   f"{r['vec_env_images_max_abs']:.3e}, poses "
                   f"{r['vec_env_poses_max_abs']:.3e} (limit "
                   f"{1e-4:.0e}), flags exact, {r['vec_env_resets']} "
                   f"resets; vs the host env {r['host_env_max_abs']:.3e} "
                   f"(limit 1e-3); the ring bit-equal")
        elif r["check"] == "K1 fp32":
            yield (f"{tag} K1 fp32, max|err| over 1e-4 (1 + |ref|) against "
                   "the plain version (passing at 1): " + ", ".join(
                       f"{n} {v:.3e} " + (
                           "(read only)" if n == "tanh GELU" else
                           ("fails" if v > 1 else "PASSES")
                           if n.startswith("scores") else
                           ("ok" if v <= 1 else "FAIL"))
                       for n, v in r["readings"].items()))
        elif r["check"] == "K8 fp32":
            yield (f"{tag} K8 fp32 {r['where']} {r['shape']}, max|err| over "
                   "1e-5 L (passing at 1): " + ", ".join(
                       f"{n} {v:.3e} " + (
                           ("ok" if v <= 1 else "FAIL") if n.startswith(
                               ("K8", "float64")) else
                           ("fails" if v > 1 else "PASSES"))
                       for n, v in r["readings"].items()))
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
    ap.add_argument("--phases", nargs="+", default=PHASES,
                    help="run only these phases (default: all)")
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
             ",".join(str(s) for s in args.seeds), ",".join(args.phases)],
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
