"""The port's sharded on-device loop (`parallel/shard.shardmap_collect`,
`shardmap_fused_round`; `make_fused_round` under a `grad_axis` agent)
against JAX's at data=2, on the CPU over gloo.

One job of 2 ranks (tests/torch_dp_worker.py, job `round`) runs one
sharded round of each flavour (plain, guided, PER, guided PER) from a
JAX train state carried into the port: 4 lanes (2 a rank) x chunk 6, a
global batch of 8 (4 a rank), 3 updates, a 64-row ring (32 a rank), a
one-block GoT at 32x40, emb-dropout 0. JAX's `shardmap_fused_round` runs
the same round on 2 of the 8 virtual CPU devices, and its draws are
injected into the ranks as tests/test_torch_fused_train.py injects them
for one device: the collection's row noise (`fold_in(key, global row)`,
the global draw, each rank taking its lanes' rows), each update's ring,
expert and PER draws (the replicated key: the same local indices on
every rank) and each update's row noise over the global rows (agent rows
then expert rows in the guided layout). The expert corpus has 20 rows:
after the round a rank's ring holds 12, so the guided update's valid
rows count min(floor(20 / 24 x 8), 8) = 6 at global scale (rank 0's 4
expert rows valid, 2 of rank 1's) and 4 at a rank's scale.

Held, with test_torch_fused_train.py's tolerances: the stats (counts
exactly, sums and metrics rtol 1e-4, atol 1e-5), each rank's ring shard
(images 1e-4, actions 1e-5, done exactly) and lanes, PER's priorities of
each shard (rtol 1e-4, atol 1e-6) and the running max (rel 1e-4, equal
on the ranks), and the parameters after the round (the two-level check).
Every flavour is held to JAX's sharded round.

Also: the sharded lanes equal the port's own unsharded collector from
the same generator, exactly (tests/test_jax_kinematic.py:290); with
patch occlusion the ranks draw different rectangles while each rank's
action noise stays its rows of the global draw
(tests/test_fault_aug.py:154); the divisibility and grad_axis errors;
and the wrong versions failing: PER's priorities from the global td and
from rank 0's rows, the stats not summed, n_expert at a rank's scale, one
fault stream on every rank.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core.mesh import MeshRuntime as JaxMeshRuntime
from dgvit_tpu.envs import jax_kinematic as jk
from dgvit_tpu.parallel.shard import \
    shardmap_fused_round as jax_shardmap_fused_round
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import state_payload
from dgvit_tpu_torch.core.mesh import Mesh, MeshRuntime
from dgvit_tpu_torch.core.rng import generator
from dgvit_tpu_torch.envs import vec_kinematic as vk
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from dgvit_tpu_torch.parallel import shard
from dgvit_tpu_torch.train import fused_train as ft
from test_torch_fused_train import (HW, RECORDS, STAT_TOL, cfg_dict,
                                    row_noise, rows_of, two_level_close,
                                    write_demos)

WORLD = 2
LANES, CHUNK, UPDATES, BATCH, CAP = 4, 6, 3, 8, 64
N_EXPERT = 20
LR = 1e-3
FLAVOURS = {"plain": (False, False), "guided": (True, False),
            "per": (False, True), "guided_per": (True, True)}


def round_cfg():
    return cfg_dict(sac={"guidence_weight": 3.0, "batch_size": BATCH})


def sharded_draws(jagent, state, rng, size, guided, prioritized):
    """JAX's draws of the sharded round's first round on every device: the
    global collection noise, the local (replicated-key) indices and the
    updates' global row noise."""
    b = BATCH // WORLD
    _, k_coll, k_upd = jax.random.split(rng, 3)
    act = np.stack([np.array(jagent._row_noise_draw(
        jax.random.split(jax.random.fold_in(k_coll, t))[0], LANES, 2))
        for t in range(CHUNK)])
    ring_idx, expert_idx, per_u, noise = [], [], [], []
    for u, k in enumerate(jax.random.split(k_upd, UPDATES)):
        if prioritized:
            ks, ke, _ = jax.random.split(k, 3)
            per_u.append(np.array(jax.random.uniform(ks, (b,))))
        elif guided:
            ks, ke = jax.random.split(k)
        else:
            ks = k
        if guided:
            expert_idx.append(np.array(jax.random.randint(
                ke, (b,), 0, N_EXPERT)))
        ring_idx.append(np.array(jax.random.randint(ks, (b,), 0, size)))
        noise.append(row_noise(jagent, state.rng, int(state.itera) + u,
                               2 * BATCH if guided else BATCH,
                               5 if guided else 3))
    t = lambda x: torch.from_numpy(np.asarray(x))
    return {"act_noise": t(act), "ring_idx": t(ring_idx),
            "expert_idx": t(expert_idx) if guided else None,
            "per_u": t(per_u) if prioritized else None,
            "update_noise": [tuple(t(n) for n in pair) for pair in noise]}


def jax_round(agent, rt, jconsts, carried, jexpert, rng, flavour):
    """JAX's sharded round of `flavour`, its results on the host."""
    guided, per = FLAVOURS[flavour]
    run, init = jax_shardmap_fused_round(
        agent, rt, jconsts, LANES, CHUNK, UPDATES, BATCH, CAP, 0.25, 1.0,
        prioritized=per, guided=guided)
    ini = init(HW)
    extra = ([ini[2]] if per else []) + ([jexpert] if guided else [])
    res = run(jax.tree_util.tree_map(jnp.asarray, carried), ini[0], ini[1],
              rng, jnp.arange(1), *extra)
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """The rank job beside JAX's four sharded rounds."""
    jcfg = JaxConfig.from_dict(round_cfg())
    jagent = JaxSACAgent(jcfg, row_noise=True)
    batch = rows_of(9, 6)
    batch["rew"], batch["done"] = batch["rew"][:, None], batch["done"][:, None]
    s1, _ = jagent.learn(jagent.init_state(3), batch)
    carried = jax.tree_util.tree_map(np.asarray, s1)
    demos = tmp_path_factory.mktemp("demos")
    write_demos(str(demos / "demo_bot_1.npz"), N_EXPERT, seed=3)
    from dgvit_tpu_torch.train.train_rl import load_expert_dataset
    expert = ft.stage_expert(load_expert_dataset(
        str(demos / "demo_bot_*.npz")), 0, "cpu")
    jexpert = {k: jnp.asarray(v.numpy()) for k, v in expert.items()}
    agent = SACAgent(Config.from_dict(round_cfg()), device="cpu")
    rng = jax.random.PRNGKey(11)
    size = LANES // WORLD * CHUNK
    st = jax.tree_util.tree_map(jnp.asarray, carried)
    inp = {"cfg": round_cfg(),
           "state": state_payload(sac_state_from_jax(agent, carried)),
           "expert": expert,
           "geometry": {"lanes": LANES, "chunk": CHUNK, "updates": UPDATES,
                        "batch": BATCH, "cap": CAP, "hw": HW,
                        "collect_lanes": 4, "collect_chunk": 10},
           "draws": {f: sharded_draws(jagent, st, rng, size, *g)
                     for f, g in FLAVOURS.items()}}
    d = tmp_path_factory.mktemp("round")
    torch.save(inp, d / "inputs.pt")
    jrt = JaxMeshRuntime.create(data=WORLD, devices=jax.devices()[:WORLD])
    jsharded = JaxSACAgent(jcfg, grad_axis="data")
    jconsts = jk.make_consts(world="rrc", records=RECORDS, image_hw=HW,
                             max_steps=8)
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        job = pool.submit(torch_dp_worker.launch, "round", WORLD, d, 400.0)
        refs = {f: pool.submit(jax_round, jsharded, jrt, jconsts, carried,
                               jexpert, rng, f) for f in FLAVOURS}
        ref = {f: r.result() for f, r in refs.items()}
        ranks = job.result()
    return {"ref": ref, "ranks": ranks, "inp": inp}


def round_mismatches(out, ref, rank, flavour):
    """Each way a rank's round differs from JAX's sharded round."""
    guided, per = FLAVOURS[flavour]
    js, jcarry, jring, jstats = ref[:4]
    bad = []
    stats = out["stats"]
    if set(stats) != set(jstats):
        bad.append(f"stat keys {sorted(stats)} vs {sorted(jstats)}")
    for k in ("goals", "collisions", "episodes", "buffer"):
        if stats[k][0] != float(jstats[k][0]):
            bad.append(f"stat {k}: {stats[k][0]} vs {jstats[k][0]}")
    for k in set(stats) & set(jstats) - {"goals", "collisions", "episodes",
                                         "buffer"}:
        if not np.allclose(stats[k], jstats[k], **STAT_TOL):
            bad.append(f"stat {k}: {stats[k]} vs {jstats[k]}")
    cap = CAP // WORLD
    rows = slice(rank * cap, (rank + 1) * cap)
    for f in ft.RING_FIELDS:
        tol = 1e-5 if f == "act" else 1e-4
        if not np.allclose(out["ring"][f].numpy(),
                           np.asarray(getattr(jring, f))[rows], atol=tol,
                           rtol=0):
            bad.append(f"ring {f}")
    lanes = slice(rank * LANES // WORLD, (rank + 1) * LANES // WORLD)
    for k in ("rec_idx", "steps"):
        if not np.array_equal(out["lanes"][k].numpy(),
                              np.asarray(getattr(jcarry[0], k))[lanes]):
            bad.append(f"lanes {k}")
    if per:
        jper = ref[4]
        if not np.allclose(out["prios"].numpy(),
                           np.asarray(jper.prios)[rows], rtol=1e-4,
                           atol=1e-6):
            bad.append("priorities")
        if out["max_p"] != pytest.approx(float(jper.max_p), rel=1e-4):
            bad.append(f"max_p {out['max_p']} vs {float(jper.max_p)}")
    for which in ("actor", "critic", "critic_target"):
        try:
            two_level_close(out["state"][which], params_from_jax(
                getattr(js, f"{which}_params")), lr=LR * UPDATES)
        except AssertionError as e:
            bad.append(f"{which}: {e}")
    if abs(out["state"]["log_alpha"] - float(js.log_alpha)) > 1e-5:
        bad.append("log_alpha")
    return bad


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_sharded_round_matches_jax(rounds, flavour):
    for rank, out in enumerate(rounds["ranks"]):
        bad = round_mismatches(out[flavour], rounds["ref"][flavour], rank,
                               flavour)
        assert not bad, f"rank {rank}: {bad[:8]}"


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_ranks_hold_one_state_and_stats(rounds, flavour):
    """Both ranks end with the same parameters, bit for bit, the same
    stats and (PER) the same running max; the stats are the sums of the
    ranks' shards (buffer: both rings' rows)."""
    a, b = (r[flavour] for r in rounds["ranks"])
    for kind in ("actor", "critic", "critic_target"):
        for n, x in a["state"][kind].items():
            assert torch.equal(x, b["state"][kind][n]), f"{kind}.{n}"
    assert {k: v.tolist() for k, v in a["stats"].items()} == \
        {k: v.tolist() for k, v in b["stats"].items()}
    assert a["stats"]["buffer"][0] == a["cursor"] + b["cursor"]
    assert a["stats"]["reward_sum"][0] == pytest.approx(
        float(a["ring"]["rew"].sum() + b["ring"]["rew"].sum()), rel=1e-5)
    if FLAVOURS[flavour][1]:
        assert a["max_p"] == b["max_p"]
    if FLAVOURS[flavour][0]:
        assert a["stats"]["n_expert"][0] == 6.0


@pytest.mark.parametrize("wrong,flavour", [
    ("per_global_td", "per"), ("per_rank0_rows", "per"),
    ("stats_local", "plain"), ("n_expert_local", "guided")])
def test_wrong_rounds_fail(rounds, wrong, flavour):
    bad = [round_mismatches(r[f"wrong_{wrong}"], rounds["ref"][flavour],
                            rank, flavour)
           for rank, r in enumerate(rounds["ranks"])]
    assert any(bad), f"the checks passed a wrong round ({wrong})"


def test_sharded_lanes_equal_unsharded(rounds):
    """The union of the ranks' lanes is the unsharded collector's from the
    same generator, exactly (10 steps at max_steps 8: auto-resets advance
    the record table by the global lane count)."""
    parts = [r["collect"]["traj"] for r in rounds["ranks"]]
    ref = rounds["ranks"][0]["collect"]["unsharded"]
    assert ref["episode_end"].sum() > 0
    for k, v in ref.items():
        got = torch.cat([p[k] for p in parts], dim=1)
        assert torch.equal(got, v), k


def test_fault_draws_differ_across_ranks_noise_stays(rounds):
    """Patch occlusion: the same lane slot of each rank gets another
    rectangle (exact zeros are the patch), and each rank's action noise
    is its rows of the global draw; with one fault stream on every rank
    the rectangles are the same, which the check fails."""
    lanes = rounds["inp"]["geometry"]["collect_lanes"]
    b = lanes // WORLD
    g = generator(7)
    full = [torch.randn((lanes, 2), generator=g) for _ in range(2)]
    masks = {}
    for name in ("faults", "faults_replicated"):
        outs = [r["collect"][name] for r in rounds["ranks"]]
        masks[name] = [o["first"] == 0 for o in outs]
        assert all(m.any() for m in masks[name])
        for rank, o in enumerate(outs):
            assert len(o["noise"]) == 2
            for used, f in zip(o["noise"], full):
                assert torch.equal(used, f[rank * b:(rank + 1) * b])
    assert not torch.equal(*masks["faults"])
    assert torch.equal(*masks["faults_replicated"])


def test_divisibility_and_axis_errors():
    """Sizes that do not split over the ranks, and an agent without the
    data axis, raise by name before anything runs."""
    rt = MeshRuntime(Mesh(data=2, model=1, seq=1, rank=0, group=None,
                          device=torch.device("cpu")))
    cfg = Config.from_dict(round_cfg())
    agent = SACAgent(cfg, device="cpu", grad_axis="data")
    consts = vk.make_consts(world="rrc", records=default_records(seed=0),
                            image_hw=HW, max_steps=8, device="cpu")
    with pytest.raises(ValueError, match="batch 3 .* 2 ranks"):
        shard.shardmap_collect(agent, rt, consts, 3, 4, 0.25, 1.0)
    for sizes, name in (((3, 8, 64), "n_envs 3"), ((4, 5, 64), "batch_size 5"),
                        ((4, 8, 33), "ring_capacity 33")):
        with pytest.raises(ValueError, match=f"{name} .* 2 ranks"):
            shard.shardmap_fused_round(agent, rt, consts, sizes[0], 6, 1,
                                       sizes[1], sizes[2], 0.25, 1.0)
    plain = SACAgent(cfg, device="cpu")
    with pytest.raises(ValueError, match="grad_axis='data'"):
        shard.shardmap_collect(plain, rt, consts, 4, 4, 0.25, 1.0)
    with pytest.raises(ValueError, match="grad_axis='data'"):
        shard.shardmap_fused_round(plain, rt, consts, 4, 6, 1, 8, 64, 0.25,
                                   1.0)
