"""Rank processes of the port's data-parallel tests
(tests/test_torch_{mesh,shard,shard_four,shard_round,elastic,
fleet_mesh}.py), on the CPU over gloo.

`launch(job, world, workdir)` starts `world` processes of this file, one
a rank, joined through `core/distributed.initialize` (torchrun's
variables, a free localhost port); each runs every case of `job` in one
go and saves what it saw to workdir/<job>_<rank>.pt, which `launch`
returns rank by rank for the parent test to compare. A failing rank fails
the launch with its output. The ranks import the port alone, never JAX:
the parent writes what they need (the carried state, batches, JAX's
noise) to workdir/inputs.pt first.

    python tests/torch_dp_worker.py JOB RANK WORLD PORT WORKDIR
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THREADS = 1          # torch threads a rank (the tests run beside others)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: str, world: int, workdir, timeout: float = 240.0):
    """Run `job` on `world` gloo ranks; their results, rank by rank."""
    import torch

    workdir = Path(workdir)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(THREADS))
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(port),
         str(workdir)], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs, deadline = [], time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{job}: rank {r} timed out")
            if p.returncode != 0:
                raise AssertionError(
                    f"{job}: rank {r} exited {p.returncode}:\n"
                    f"{outs[-1][-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(workdir / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def named(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def grads(state):
    return {f"{k}.{n}": p.grad.detach().clone()
            for k in ("actor", "critic")
            for n, p in getattr(state, k).named_parameters()
            if p.grad is not None}


def snapshot(state):
    """The parameters of actor, critic and target, log_alpha and itera."""
    return {"actor": named(state.actor), "critic": named(state.critic),
            "critic_target": named(state.critic_target),
            "log_alpha": state.log_alpha.item(), "itera": state.itera}


def summed_grads(agent):
    """A wrong data axis: the group's SUM of the gradients, not its mean."""
    import torch

    def sync(opt):
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        flat = agent._all_sum(torch.cat([p.grad.reshape(-1)
                                         for p in params]))
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    agent._sync_grads = sync


def rows_from_zero(agent, rank, world):
    """A wrong data axis: every rank takes noise rows 0..b-1."""
    import torch
    agent._rows = lambda b, be=0: (torch.arange(b + be), world * (b + be))


def expert_contiguous(agent, rank, world):
    """A wrong data axis: the guided step's merged rows as one contiguous
    global slice (agent and expert rows not apart)."""
    import torch
    agent._rows = lambda b, be=0: (torch.arange(b + be) + rank * (b + be),
                                   world * (b + be))


WRONG = {"summed": lambda a, r, w: summed_grads(a),
         "rows_from_zero": rows_from_zero,
         "expert_contiguous": expert_contiguous}


# --------------------------------------------------------------------------
# job: shard (test_torch_shard.py)
# --------------------------------------------------------------------------

def flavor_args(inp, flavor, u):
    """The global extra arguments of update `u` of `flavor`."""
    if flavor == "per":
        return (inp["weights"][u],)
    if flavor == "guided":
        return (inp["experts"][u], inp["n_expert"])
    if flavor == "guided_per":
        return (inp["experts"][u], inp["n_expert"], inp["weights"][u])
    return ()


def run_flavor(inp, rt, flavor, wrong=None):
    """UPDATES data-parallel updates of `flavor` from the carried state
    with JAX's global noise: metrics, gradients and td of each, and the
    state after them."""
    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.parallel import shard_sac_state, shardmap_learn

    agent = SACAgent(Config.from_dict(inp["cfg"]), device="cpu", seed=3,
                     grad_axis="data")
    if wrong:
        WRONG[wrong](agent, rt.rank, rt.world)
    state = shard_sac_state(rt, load_payload(agent.init_state(),
                                             inp["state"]))
    learn = shardmap_learn(agent, rt, flavor)
    guided = flavor.startswith("guided")
    out = {"metrics": [], "grads": [], "td": []}
    for u in range(len(inp["batches"])):
        noise = inp["guided_noise" if guided else "noise"][u]
        res = learn(state, inp["batches"][u], *flavor_args(inp, flavor, u),
                    noise=noise)
        state, m = res[0], res[1]
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append(grads(state))
        out["td"].append(res[2].clone() if len(res) == 3 else None)
    out["state"] = snapshot(state)
    out["generator"] = state.generator.get_state()
    return out


def world_one_equals_none(inp, rank):
    """On a group of one rank, the data-axis agent's updates (plain, PER,
    guided, generator noise) against grad_axis None's, bit for bit, and
    the launches of collectives by the grad_axis None agent (must be
    none)."""
    import torch
    import torch.distributed as dist

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.core.mesh import MeshRuntime, use_mesh

    group = dist.new_group([0])
    if rank != 0:
        return None
    rt = MeshRuntime.create(group=group, device="cpu")
    calls = []
    runs = {}
    for axis in (None, "data"):
        agent = SACAgent(Config.from_dict(inp["cfg"]), device="cpu", seed=3,
                         grad_axis=axis)
        state = load_payload(agent.init_state(), inp["state"])
        rec = []
        real = dist.all_reduce
        dist.all_reduce = lambda *a, **k: (calls.append(axis), real(*a, **k))[1]
        try:
            with use_mesh(rt):
                for u in range(len(inp["batches"])):
                    b = inp["batches"][u]
                    state, m = agent.learn(state, b)
                    state, m2, td = agent.learn_per(state, b,
                                                    inp["weights"][u])
                    state, m3 = agent.learn_guidence(
                        state, b, inp["experts"][u], inp["n_expert"])
                    rec.append(({k: v.clone() for k, v in m.items()},
                                {k: v.clone() for k, v in m2.items()},
                                td.clone(),
                                {k: v.clone() for k, v in m3.items()},
                                grads(state)))
        finally:
            dist.all_reduce = real
        runs[axis] = (rec, snapshot(state), state.generator.get_state())
    (ra, sa, ga), (rb, sb, gb) = runs[None], runs["data"]

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return x == y

    return {"bit_equal": same(ra, rb) and same(sa, sb) and torch.equal(ga, gb),
            "none_collectives": calls.count(None)}


def live_dropout(inp, rt):
    """One data-parallel update with emb-dropout 0.1 and the generator's
    own noise: the noise each rank used, the dropout masks it drew, the
    generator's state after."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent, sac
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.models import got
    from dgvit_tpu_torch.parallel import shardmap_learn

    cfg = Config.from_dict(inp["cfg"])
    cfg.model.emb_dropout = 0.1
    agent = SACAgent(cfg, device="cpu", seed=3, grad_axis="data")
    state = load_payload(agent.init_state(), inp["state"])
    noises, masks = [], []
    sample, drop = sac.distributions.sample, got.flax_dropout

    def seen_sample(mean, log_std, generator=None, noise=None, **kw):
        noises.append(noise.clone())
        return sample(mean, log_std, generator, noise=noise, **kw)

    def seen_drop(x, rate, generator):
        y = drop(x, rate, generator)
        masks.append((y != 0).clone())
        return y

    sac.distributions.sample, got.flax_dropout = seen_sample, seen_drop
    try:
        state, m = shardmap_learn(agent, rt)(state, inp["batches"][0])
    finally:
        sac.distributions.sample, got.flax_dropout = sample, drop
    return {"noises": noises, "masks": masks,
            "generator": state.generator.get_state(),
            "finite": all(torch.isfinite(v).all().item() for v in m.values())}


def nan_rows(inp, rt):
    """nan_guard: a plain update whose global batch holds a NaN reward in
    rank 0's rows, then a clean one: skipped flags, whether the state
    moved, the counter."""
    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.parallel import shardmap_learn

    cfg = Config.from_dict(inp["cfg"])
    cfg.sac.nan_guard = True
    agent = SACAgent(cfg, device="cpu", seed=3, grad_axis="data")
    state = load_payload(agent.init_state(), inp["state"])
    learn = shardmap_learn(agent, rt)
    before = snapshot(state)
    bad = {k: v.copy() for k, v in inp["batches"][0].items()}
    bad["rew"][3] = float("nan")
    state, m = learn(state, bad, noise=inp["noise"][0])
    after = snapshot(state)
    import torch
    moved = any(not torch.equal(before[k][n], after[k][n])
                for k in ("actor", "critic", "critic_target")
                for n in before[k])
    state, m2 = learn(state, inp["batches"][1], noise=inp["noise"][1])
    return {"skipped": float(m["skipped_nonfinite"]), "moved": moved,
            "log_alpha_same": before["log_alpha"] == after["log_alpha"],
            "itera": after["itera"],
            "skipped_clean": float(m2["skipped_nonfinite"])}


def job_shard(rank, world, workdir):
    import torch

    from dgvit_tpu_torch.core.mesh import MeshRuntime

    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    rt = MeshRuntime.create(device="cpu")
    out = {f: run_flavor(inp, rt, f)
           for f in ("plain", "per", "guided", "guided_per")}
    for wrong, flavor in (("summed", "plain"), ("rows_from_zero", "plain"),
                          ("expert_contiguous", "guided")):
        out[f"wrong_{wrong}"] = run_flavor(inp, rt, flavor, wrong)
    if world == 2:
        out["world_one"] = world_one_equals_none(inp, rank)
        out["dropout"] = live_dropout(inp, rt)
        out["nan_guard"] = nan_rows(inp, rt)
    return out


# --------------------------------------------------------------------------
# job: mesh (test_torch_mesh.py)
# --------------------------------------------------------------------------

def job_mesh(rank, world, workdir):
    import numpy as np
    import torch
    import torch.distributed as dist

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core import distributed
    from dgvit_tpu_torch.core.checkpoint import state_payload
    from dgvit_tpu_torch.core.mesh import MeshRuntime, active_mesh, use_mesh
    from dgvit_tpu_torch.parallel import (shard_sac_state, sharded_learn,
                                          shardmap_learn)

    out = {"backend": dist.get_backend(), "rank": distributed.rank(),
           "world": distributed.world_size(),
           "initialize_again": distributed.initialize()}
    rt = MeshRuntime.create(data=world, device="cpu")
    absorbed = MeshRuntime.create(device="cpu")
    out["mesh"] = (rt.world, rt.rank, absorbed.world, rt.mesh.shape)
    refused = {}
    for kw in ({"data": world + 1}, {"data": 1}, {"model": 2}, {"seq": 2}):
        try:
            MeshRuntime.create(device="cpu", **kw)
            refused[str(kw)] = None
        except (ValueError, NotImplementedError) as e:
            refused[str(kw)] = (type(e).__name__, str(e))
    out["refused"] = refused
    x = torch.arange(8 * 3).reshape(8, 3)
    out["shard"] = rt.shard_batch({"x": x, "n": np.arange(8),
                                   "k": 5})
    out["slice"] = distributed.local_batch_slice(8)
    t = torch.full((3,), float(rank + 1))
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    rt.replicate([t, lin])
    out["replicated"] = (t.clone(), lin.weight.detach().clone())
    out["object"] = rt.broadcast_object({"from": rank})
    with use_mesh(rt):
        out["active"] = active_mesh() is rt.mesh
    out["inactive"] = active_mesh() is None

    # shard_sac_state: rank 0 after one update, the others fresh from
    # another seed, all end with rank 0's state
    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    cfg = Config.from_dict(inp["cfg"])
    agent = SACAgent(cfg, device="cpu", seed=rank + 1)
    state = agent.init_state()
    if rank == 0:
        state, _ = agent.learn(state, inp["batches"][0])
    shard_sac_state(rt, state)
    payload = state_payload(state)
    out["state"] = {k: payload[k] for k in ("actor", "log_alpha", "itera",
                                            "generator")}
    out["opt_steps"] = sorted(float(s["step"]) for s in
                              payload["critic_opt"]["state"].values())
    # sharded_learn: a grad_axis None agent's data-parallel twin
    runs = []
    for make in (lambda a: sharded_learn(a, rt),
                 lambda a: shardmap_learn(SACAgent(
                     cfg, device="cpu", seed=1, grad_axis="data"), rt)):
        a = SACAgent(cfg, device="cpu", seed=1)
        st = a.init_state()
        st, m = make(a)(st, inp["batches"][1], noise=inp["noise"][1])
        runs.append((snapshot(st), {k: float(v) for k, v in m.items()}))
    out["sharded_learn"] = runs
    t0 = time.time()
    if rank == 1:
        time.sleep(0.5)
    rt.barrier()
    out["barrier"] = (t0, time.time())
    return out


# --------------------------------------------------------------------------
# job: elastic (test_torch_elastic.py)
# --------------------------------------------------------------------------

def job_elastic(rank, world, workdir):
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.elastic import (ElasticCheckpointer,
                                              SimulatedFault, reshard_state,
                                              run_elastic)
    from dgvit_tpu_torch.core.mesh import MeshRuntime
    from dgvit_tpu_torch.parallel import shard_sac_state, shardmap_learn

    workdir = Path(workdir)
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    rt = MeshRuntime.create(device="cpu")
    out = {}

    # the fault drill: N plain updates with emb-dropout live, a fault after
    # update FAULT_AFTER on the first attempt, checkpoints every 3
    cfg = Config.from_dict(inp["cfg"])
    cfg.model.emb_dropout = 0.1
    agent = SACAgent(cfg, device="cpu", seed=3, grad_axis="data")
    learn = shardmap_learn(agent, rt)
    batches = inp["batches"]
    n, fault_after = inp["updates"], inp["fault_after"]

    def template():
        return shard_sac_state(rt, agent.init_state())

    def loop(state, start, ck, fail_at=None):
        for step in range(start, n):
            if step == fail_at:
                raise SimulatedFault(f"injected after update {step}")
            state, _ = learn(state, batches[step])
            ck.maybe_save(step + 1, state)
        return state

    ref = loop(template(), 0, ElasticCheckpointer(workdir / "ref", 100))
    attempts = []

    def train_fn(state, start, ck):
        attempts.append(start)
        return loop(state, start, ck,
                    fault_after if len(attempts) == 1 else None)

    ck = ElasticCheckpointer(workdir / "elastic", interval=3, keep=2)
    final = run_elastic(train_fn, template, ck, max_restarts=2)
    out["attempts"] = attempts
    out["ref"], out["final"] = snapshot(ref), snapshot(final)
    out["ref_generator"] = ref.generator.get_state()
    out["final_generator"] = final.generator.get_state()
    out["kept"] = sorted(p.name for p in (workdir / "elastic").iterdir())

    # the barriers: rank 1 arrives late; nobody leaves save before it
    # arrives, and the file is whole when anybody leaves
    ck2 = ElasticCheckpointer(workdir / "barrier", interval=1, keep=1)
    if rank == 1:
        time.sleep(1.0)
    t_in = time.time()
    path = ck2.save(5, final)
    out["barrier"] = {"in": t_in, "out": time.time(), "path": path,
                      "whole": (Path(path) / "train_state.pt").is_file()}
    resumed, start = ck2.resume(agent.init_state())
    out["barrier"]["start"] = start
    out["barrier"]["itera"] = resumed.itera

    # topology: emb-dropout 0; an update at world 2, its checkpoint, the
    # next update at world 2 (the parent resumes the checkpoint at world 1)
    cfg0 = Config.from_dict(inp["cfg"])
    agent0 = SACAgent(cfg0, device="cpu", seed=3, grad_axis="data")
    learn0 = shardmap_learn(agent0, rt)
    st = shard_sac_state(rt, agent0.init_state())
    st, _ = learn0(st, batches[0], noise=inp["noise"][0])
    ElasticCheckpointer(workdir / "topo", interval=1).save(1, st)
    restored, start = ElasticCheckpointer(workdir / "topo").resume(
        agent0.init_state())
    restored = reshard_state(restored, rt)
    restored, m = learn0(restored, batches[1], noise=inp["noise"][1])
    out["topology"] = {"start": start, "state": snapshot(restored),
                       "metrics": {k: float(v) for k, v in m.items()}}
    return out


# --------------------------------------------------------------------------
# job: round (test_torch_shard_round.py)
# --------------------------------------------------------------------------

ROUND_FLAVOURS = {"plain": (False, False), "guided": (True, False),
                  "per": (False, True), "guided_per": (True, True)}


def round_wrong(wrong, world):
    """Patch a wrong version of the sharded round in (undone by the
    returned callable): PER's priorities from the global td or from rank
    0's rows; the stats not summed; n_expert counted at the rank's
    scale; one fault stream on every rank."""
    from dgvit_tpu_torch.train import fused_train as ft
    from dgvit_tpu_torch.train import vec_rollout as vr

    name, orig = {
        "per_global_td": ("rank_rows", ft.rank_rows),
        "per_rank0_rows": ("rank_rows", ft.rank_rows),
        "stats_local": ("group_reduce", ft.group_reduce),
        "n_expert_local": ("expert_rows", ft.expert_rows),
        "fault_replicated": ("rank_fault_generator",
                             vr.rank_fault_generator)}[wrong]
    mod = vr if wrong == "fault_replicated" else ft
    setattr(mod, name, {
        "per_global_td": lambda td, rank, b: td,
        "per_rank0_rows": lambda td, rank, b: td[:b],
        "stats_local": lambda t, mesh, op="sum":
            orig(t, mesh, op) if op == "max" else t,
        "n_expert_local": lambda n, size, b: orig(n, size // world,
                                                  b // world),
        "fault_replicated": lambda gen, rank, device: gen}[wrong])
    return lambda: setattr(mod, name, orig)


def round_run(inp, rt, consts, flavour, wrong=None):
    """One sharded fused round of `flavour` from the carried state with
    JAX's draws: the stats, the rank's ring shard, its lanes, PER's state
    and the train state after."""
    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.parallel import shard_sac_state
    from dgvit_tpu_torch.parallel.shard import shardmap_fused_round
    from dgvit_tpu_torch.train.fused_train import RING_FIELDS

    guided, per = ROUND_FLAVOURS[flavour]
    g = inp["geometry"]
    undo = round_wrong(wrong, rt.world) if wrong else None
    try:
        agent = SACAgent(Config.from_dict(inp["cfg"]), device="cpu",
                         grad_axis="data")
        state = shard_sac_state(rt, load_payload(agent.init_state(),
                                                 inp["state"]))
        run, init = shardmap_fused_round(
            agent, rt, consts, g["lanes"], g["chunk"], g["updates"],
            g["batch"], g["cap"], 0.25, 1.0, prioritized=per, guided=guided)
        carry, ring, *pr = init(tuple(g["hw"]))
        res = run(state, carry, ring, [0],
                  inp["expert"] if guided else None,
                  [inp["draws"][flavour]], per=pr[0] if per else None)
    finally:
        if undo:
            undo()
    state, carry, ring, stats = res[:4]
    out = {"stats": stats, "cursor": ring.cursor,
           "ring": {f: getattr(ring, f).clone() for f in RING_FIELDS},
           "lanes": {k: getattr(carry[0], k).clone()
                     for k in ("rec_idx", "steps", "x")},
           "state": snapshot(state)}
    if per:
        out["prios"] = res[4].prios.clone()
        out["max_p"] = res[4].max_p.item()
    return out


def round_collect(inp, rt, consts):
    """The sharded collection: the rank's lanes, and on rank 0 the
    unsharded collector's from the same generator seed; with patch
    occlusion, the rank's first frame and the noise its actions used,
    with the fault streams right and replicated."""
    from dgvit_tpu_torch.agents import SACAgent, sac
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.core.rng import generator
    from dgvit_tpu_torch.envs.vec_kinematic import vec_reset
    from dgvit_tpu_torch.parallel.shard import shardmap_collect
    from dgvit_tpu_torch.train.vec_rollout import make_collect_fn

    g = inp["geometry"]
    cfg = Config.from_dict(inp["cfg"])
    agent = SACAgent(cfg, device="cpu", grad_axis="data")
    actor = load_payload(agent.init_state(), inp["state"]).actor
    lanes, steps = g["collect_lanes"], g["collect_chunk"]
    collect, init = shardmap_collect(agent, rt, consts, lanes, steps, 0.25,
                                     1.0)
    out = {"traj": collect(actor, init(), generator(7))[1]}
    if rt.rank == 0:
        one = SACAgent(cfg, device="cpu")
        fn = make_collect_fn(one, consts, steps, 0.25, 1.0)
        out["unsharded"] = fn(actor, vec_reset(consts, lanes),
                              generator(7))[1]
    knobs = {"patch_occlusion": 0.25}
    collect_f, _ = shardmap_collect(agent, rt, consts, lanes, 2, 0.25, 1.0,
                                    fault_knobs=knobs)
    sample = sac.distributions.sample
    for name, wrong in (("faults", None),
                        ("faults_replicated", "fault_replicated")):
        noises = []

        def seen(mean, log_std, generator=None, noise=None, **kw):
            noises.append(noise.clone())
            return sample(mean, log_std, generator, noise=noise, **kw)

        undo = round_wrong(wrong, rt.world) if wrong else None
        sac.distributions.sample = seen
        try:
            traj = collect_f(actor, init(), generator(7),
                             fault_gen=generator(8))[1]
        finally:
            sac.distributions.sample = sample
            if undo:
                undo()
        out[name] = {"first": traj["obs"][0, 0].clone(), "noise": noises}
    return out


def job_round(rank, world, workdir):
    import torch

    from dgvit_tpu_torch.core.mesh import MeshRuntime
    from dgvit_tpu_torch.envs import vec_kinematic as vk
    from dgvit_tpu_torch.envs.kinematic import default_records

    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    rt = MeshRuntime.create(device="cpu")
    consts = vk.make_consts(world="rrc", records=default_records(seed=0),
                            image_hw=tuple(inp["geometry"]["hw"]),
                            max_steps=8, device="cpu")
    out = {f: round_run(inp, rt, consts, f) for f in ROUND_FLAVOURS}
    for wrong, flavour in (("per_global_td", "per"),
                           ("per_rank0_rows", "per"),
                           ("stats_local", "plain"),
                           ("n_expert_local", "guided")):
        out[f"wrong_{wrong}"] = round_run(inp, rt, consts, flavour, wrong)
    out["collect"] = round_collect(inp, rt, consts)
    return out


# --------------------------------------------------------------------------
# job: fleet (test_torch_fleet_mesh.py)
# --------------------------------------------------------------------------

def clone_tree(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def fleet_run(inp, rt, rank, world, workdir, name, per, guided):
    """train_fleet(mesh_data=world) of one flavour on this rank (the fleet
    on rank 0), the first update's inputs and result recorded, then that
    update replayed through shardmap_learn from the state before it."""
    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_payload, state_payload
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs.kinematic import default_records
    from dgvit_tpu_torch.parallel import shardmap_learn
    from dgvit_tpu_torch.train import train_fleet as tf

    cfg = Config.from_dict(inp["cfg"])
    cfg.sac.prioritized_replay = per
    cfg.train.pre_buffer = guided
    cfg.train.save = True
    first = {}
    real = tf.mesh_learn

    def recorded(learn_fns, state, flavor, n_expert, arrays):
        keep = not first
        if keep:
            first["before"] = clone_tree(state_payload(state))
            first["args"] = (flavor, n_expert, clone_tree(arrays))
        res = real(learn_fns, state, flavor, n_expert, arrays)
        if keep:
            first["after"] = snapshot(res[0])
        return res

    envs = ([KinematicNavEnv(default_records(seed=s), image_hw=(32, 40))
             for s in (100, 101)] if rank == 0 else [])
    out_dir = Path(workdir) / f"{name}_rank{rank}"
    tf.mesh_learn = recorded
    try:
        res = tf.train_fleet(cfg, envs, out_dir=str(out_dir),
                             max_episodes=2, max_wait_ms=10.0,
                             mesh_data=world, device="cpu",
                             expert_glob=inp["expert_glob"] if guided
                             else None)
    finally:
        tf.mesh_learn = real
    agent = SACAgent(cfg, device="cpu", seed=cfg.train.seed,
                     grad_axis="data")
    state = load_payload(agent.init_state(cfg.train.seed), first["before"])
    flavor, k, arrays = first["args"]
    state = tf.mesh_learn({flavor: shardmap_learn(agent, rt, flavor)},
                          state, flavor, k, arrays)[0]
    return {"state": snapshot(res["state"]), "updates": res["updates"],
            "itera": res["state"].itera, "errors": res.get("errors"),
            "flavor": flavor,
            "files": sorted(str(p.relative_to(out_dir))
                            for p in out_dir.rglob("*") if p.is_file())
            if out_dir.exists() else [],
            "first_replayed": snapshot(state), "first": first["after"]}


def job_fleet(rank, world, workdir):
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.mesh import MeshRuntime
    from dgvit_tpu_torch.train import train_fleet as tf

    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    rt = MeshRuntime.create(device="cpu")
    out = {name: fleet_run(inp, rt, rank, world, workdir, name, per, guided)
           for name, per, guided in (("plain", False, False),
                                     ("guided_per", True, True))}
    try:
        tf.train_fleet(Config.from_dict(inp["cfg"]), [], mesh_data=world + 2,
                       device="cpu")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


JOBS = {"shard": job_shard, "mesh": job_mesh, "elastic": job_elastic,
        "round": job_round, "fleet": job_fleet}


def main(argv):
    job, rank, world, port, workdir = argv
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE=world, LOCAL_RANK=rank,
                      LOCAL_WORLD_SIZE=world)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(THREADS)
    from dgvit_tpu_torch.core import distributed

    assert distributed.initialize(backend="gloo", timeout_s=180.0)
    try:
        out = JOBS[job](int(rank), int(world), workdir)
        torch.save(out, Path(workdir) / f"{job}_{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
