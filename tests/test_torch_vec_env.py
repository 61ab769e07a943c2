"""The port's batched env (dgvit_tpu_torch/envs/vec_kinematic.py), its
collection (train/vec_rollout.py), the tensor reward functions and the seed
functions (core/rng.py) against the JAX package's, on the CPU.

The env: `vec_reset` and `vec_step` of both packages under the same
scripted actions (tests/test_jax_kinematic.py's arcs, phase-shifted per
lane), B = 1 and 5, worlds rrc, hospital, rand3 and randm4 under both
`world_assign` values, with max_steps 12 so that lanes hit the cap and
auto-reset within the 30 steps. `done`, `target`, `collided`,
`truncated`, `rec_idx` and `steps` must be identical; positions, goals,
rewards and images within 1e-4 (fp32 on both sides; the bearing
linspaces differ in the last place, arccos/arctan2 by an ulp or two).
`_world_of` is bit-equal to JAX's over thousands of record indices.
Against the port's own host env (float64): rewards within 2e-3, goals
and images within 1e-3, flags equal, as the JAX test allows.

Collection: one chunk (B = 4, T = 8, max_steps 5 so lanes reset inside
it) of `make_collect_fn` with JAX's action noise injected (`fold_in(rng,
t)` -> split -> the actor's row noise): every transition field within
1e-4 (actions 1e-5), the masks and flags exact; single frames and a
frame stack of 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.envs import jax_kinematic as jk
from dgvit_tpu.envs import reward as jr
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu.train import vec_rollout as jvr
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import rng as prng
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs import reward as pr
from dgvit_tpu_torch.envs import vec_kinematic as vk
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.envs.worlds import get_world
from dgvit_tpu_torch.serve import make_action_fn
from dgvit_tpu_torch.train import vec_rollout as vr

HW = (32, 40)
TOL = 1e-4
FLAGS = ("done", "target", "collided", "truncated")
_RECORDS = {}


def records(world):
    """The port's records of a preset (bit-equal to the JAX package's,
    tests/test_torch_envs.py; JAX's sampler takes seconds a call)."""
    if world not in _RECORDS:
        _RECORDS[world] = default_records(
            seed=0, world=None if world == "rrc" else get_world(world))
    return _RECORDS[world]


def consts_pair(world, assign="reset", max_steps=12, hw=HW):
    recs = records(world) if world in ("rrc", "hospital") else None
    return (jk.make_consts(world=world, records=recs, image_hw=hw,
                           max_steps=max_steps, seed=0, world_assign=assign),
            vk.make_consts(world=world, records=recs, image_hw=hw,
                           max_steps=max_steps, seed=0, world_assign=assign,
                           device="cpu"))


def jax_env(jc, **kw):
    """JAX's vec_reset and vec_step, compiled for these consts (30 steps
    run several times faster than op by op)."""
    return (jax.jit(functools.partial(jk.vec_reset, jc), static_argnums=0),
            jax.jit(functools.partial(jk.vec_step, jc, **kw)))


def scripted(T, B):
    """Command-unit [v, w] arcs (tests/test_jax_kinematic.py:14-19),
    phase-shifted per lane, fast enough to reach goals and walls."""
    t = np.arange(T)[:, None] + 3 * np.arange(B)[None, :]
    v = 0.12 + 0.05 * np.sin(t / 3.0)
    w = 0.4 * np.sin(t / 5.0)
    return (np.stack([v, w], axis=-1) * [6.0, 1.0]).astype(np.float32)


def close(port, ref, what, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol,
                               rtol=0, err_msg=what)


def equal(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


def check_state(ps, js, where):
    for f in ("rec_idx", "steps"):
        equal(getattr(ps, f), getattr(js, f), f"{f} {where}")
    for f in ("x", "y", "theta", "goal_x", "goal_y", "dist_old"):
        close(getattr(ps, f), getattr(js, f), f"{f} {where}")


# --------------------------------------------------------------------------
# the env
# --------------------------------------------------------------------------

WORLDS = ["rrc", "hospital", "rand3", "randm4"]


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("assign", ["reset", "lane"])
@pytest.mark.parametrize("world", WORLDS)
def test_vec_env_matches_jax(world, assign, batch):
    jc, pc = consts_pair(world, assign)
    jreset, jstep = jax_env(jc)
    js, jo, jg = jreset(batch)
    ps, po, pg = vk.vec_reset(pc, batch)
    check_state(ps, js, "at reset")
    close(po, jo, "obs at reset")
    close(pg, jg, "to_goal at reset")
    acts = scripted(30, batch)
    ended = 0
    for t in range(30):
        jout = jstep(js, acts[t])
        pout = vk.vec_step(pc, ps, torch.from_numpy(acts[t]))
        for f in FLAGS:
            equal(getattr(pout, f), getattr(jout, f), f"{f} at {t}")
        for f in ("obs", "next_obs", "to_goal", "next_to_goal", "reward"):
            close(getattr(pout, f), getattr(jout, f), f"{f} at {t}")
        js, ps = jout.state, pout.state
        check_state(ps, js, f"at {t}")
        ended += int(np.asarray(jout.done | jout.truncated).sum())
    assert ended >= batch     # every lane ended an episode at least once


def test_stride_and_truncation_match_jax():
    """A record stride other than the lane count (a sharded run's), and
    truncation at max_steps without done."""
    jc, pc = consts_pair("rrc", max_steps=4)
    jreset, jstep = jax_env(jc, stride=7)
    js, _, _ = jreset(3)
    ps, _, _ = vk.vec_reset(pc, 3)
    still = np.zeros((3, 2), np.float32)
    truncated = 0
    for t in range(9):
        jout = jstep(js, still)
        pout = vk.vec_step(pc, ps, torch.from_numpy(still), stride=7)
        for f in FLAGS:
            equal(getattr(pout, f), getattr(jout, f), f"{f} at {t}")
        js, ps = jout.state, pout.state
        check_state(ps, js, f"at {t}")
        truncated += int(pout.truncated.sum())
        assert not pout.done.any()
    assert truncated == 6
    assert ps.rec_idx.tolist() == [14, 15, 16]


@pytest.mark.parametrize("k", [1, 3, 32])
@pytest.mark.parametrize("assign", ["reset", "lane"])
def test_world_of_is_bit_equal_to_jax(k, assign):
    jc, pc = consts_pair("rrc")
    jc = jc._replace(world=jc.world._replace(boxes=jnp.zeros((k, 1, 4))),
                     world_assign=assign)
    pc = pc._replace(boxes=torch.zeros(k, 1, 4), world_assign=assign)
    rng = np.random.default_rng(k)
    idx = np.concatenate([np.arange(5000),
                          rng.integers(0, 2 ** 31 - 1, 3000)]).astype(
        np.int32)
    got = vk._world_of(pc, torch.from_numpy(idx))
    want = np.asarray(jk._world_of(jc, jnp.asarray(idx)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if assign == "reset" and k > 1:
        assert len(np.unique(want)) == k


@pytest.mark.parametrize("world", ["rrc", "hospital"])
def test_single_lane_matches_the_host_env(world):
    """B = 1 replays the port's host env (float64) step for step until its
    first done (tests/test_jax_kinematic.py:22)."""
    recs = records(world)
    host = KinematicNavEnv(recs, image_hw=HW, max_steps=100, world=world)
    r = host.reset()
    c = vk.make_consts(world=world, records=recs, image_hw=HW,
                       max_steps=100, device="cpu")
    state, obs, goal = vk.vec_reset(c, 1)
    close(obs[0], r.state[..., 0], "obs at reset")
    close(goal[0], r.to_goal, "to_goal at reset")
    acts = scripted(25, 1)[:, 0]
    for i in range(25):
        s = host.step(list(acts[i]), i)
        out = vk.vec_step(c, state, torch.from_numpy(acts[i][None]))
        state = out.state
        assert bool(out.done[0]) == s.done, f"done at {i}"
        assert bool(out.target[0]) == s.target, f"target at {i}"
        np.testing.assert_allclose(float(out.reward[0]), s.reward,
                                   atol=2e-3, rtol=1e-4)
        close(out.next_to_goal[0], s.to_goal, f"goal at {i}", 1e-3)
        close(out.next_obs[0], s.state[..., 0], f"image at {i}", 1e-3)
        if s.done:
            break


@pytest.mark.parametrize("world", ["rand3", "randm4", "rrc"])
def test_make_consts_tables_match_jax(world):
    jc, pc = consts_pair(world)
    equal(pc.boxes, jc.world.boxes, "boxes")
    equal(pc.arena, jc.world.arena, "arena")
    equal(pc.records, jc.records, "records")
    assert (pc.image_h, pc.image_w, pc.max_steps, pc.dt) == \
        (jc.image_h, jc.image_w, jc.max_steps, jc.dt)


def test_make_consts_refusals():
    with pytest.raises(ValueError, match="world_assign"):
        vk.make_consts("rand3", world_assign="random", device="cpu")
    with pytest.raises(ValueError, match="explicit records"):
        vk.make_consts("rand3", records=records("rrc"), device="cpu")


# --------------------------------------------------------------------------
# the tensor reward functions
# --------------------------------------------------------------------------

def test_reward_lanes_match_jax():
    rng = np.random.default_rng(0)
    n = 64
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    ox, oy, gx, gy, th = f(-5, 5), f(-3, 4), f(-5, 5), f(-3, 4), f(-3.2, 3.2)
    gx[:4], gy[:4] = ox[:4], oy[:4]          # on the goal
    v, w = f(0, 0.5), f(-1, 1)
    args = [torch.from_numpy(a) for a in (ox, oy, gx, gy, th)]
    jargs = [jnp.asarray(a) for a in (ox, oy, gx, gy, th)]
    close(pr.heading_error_lanes(*args), jr.heading_error(*jargs),
          "heading_error", 1e-6)
    close(pr.polar_goal_lanes(*args, torch.from_numpy(v), torch.from_numpy(w)),
          jax.vmap(jr.polar_goal)(*jargs, jnp.asarray(v), jnp.asarray(w)),
          "polar_goal", 1e-6)
    dist = f(0.3, 0.7)
    dist[:3] = np.nextafter(np.float32(0.5), np.float32([0, 1, 0.5]))
    old = dist + f(-0.1, 0.1)
    col = rng.uniform(size=n) < 0.2
    got = pr.step_reward_lanes(*(torch.from_numpy(a) for a in
                                 (old, dist, col, v, w)))
    want = jr.step_reward(*(jnp.asarray(a) for a in (old, dist, col, v, w)))
    for k in ("done", "target"):
        equal(getattr(got, k), getattr(want, k), k)
    for k in ("reward", "r_arret", "dist"):
        close(getattr(got, k), getattr(want, k), k, 1e-5)
    assert got.target[0] and not got.target[1:3].any()


# --------------------------------------------------------------------------
# the seed stream
# --------------------------------------------------------------------------

def test_rng_stream():
    """step_key: distinct seeds by step and by root, in [0, 2**63); equal
    seeds give equal generator draws."""
    keys = {prng.step_key(3, r) for r in range(1000)}
    assert len(keys) == 1000 and prng.step_key(3, 0) != prng.step_key(4, 0)
    assert all(0 <= k < 2 ** 63 for k in keys)
    assert prng.step_key(3, 5) == prng.step_key(3, 5)
    seed = prng.step_key(7, 0)
    g1, g2 = prng.generator(seed), prng.generator(seed)
    assert torch.equal(torch.randn(4, generator=g1),
                       torch.randn(4, generator=g2))


# --------------------------------------------------------------------------
# collection against JAX make_collect_fn
# --------------------------------------------------------------------------

MODEL = {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
         "image_size": HW, "patch_size": (16, 20), "emb_dropout": 0.0}
LANES, STEPS = 4, 8
FIELDS = ("obs", "act", "pobs", "next_pobs", "rew", "next_obs", "done",
          "episode_end", "store", "target", "collided")
EXACT = ("done", "episode_end", "store", "target", "collided")


@pytest.fixture(scope="module", params=[0, 2], ids=["frames", "stack2"])
def chunk(request):
    """One chunk of JAX's collection and of the port's, from the same
    actor and lanes, with JAX's action noise."""
    fs = request.param
    model = dict(MODEL, patch_mode="channels") if fs else MODEL
    env = {"max_steps": 5}
    if fs:
        env.update(use_frame_stack=True, frame_stack=fs)
    jcfg = JaxConfig.from_dict({"model": model, "env": env})
    cfg = Config.from_dict({"model": model, "env": env})
    jagent = JaxSACAgent(jcfg, row_noise=True)
    obs0 = np.zeros((1, fs, *HW) if fs else (1, *HW))
    params = jax_build_actor(jcfg).init(jax.random.PRNGKey(5), obs0,
                                        np.zeros((1, 2)))["params"]
    jc, pc = consts_pair("rrc", max_steps=5)
    jcollect = jax.jit(jvr.make_collect_fn(jagent, jc, STEPS, 0.25, 1.0,
                                           frame_stack=fs))
    carry = jk.vec_reset(jc, LANES)
    if fs:
        carry = (carry[0], jvr.stack_init(carry[1], fs), carry[2])
    rng = jax.random.PRNGKey(21)
    _, jtraj = jcollect(params, carry, rng)
    noise = np.stack([np.array(jagent._row_noise_draw(
        jax.random.split(jax.random.fold_in(rng, t))[0], LANES, 2))
        for t in range(STEPS)])

    agent = SACAgent(cfg, device="cpu")
    actor = make_action_fn(cfg, jax.tree_util.tree_map(np.asarray, params),
                           dtype=torch.float32, device="cpu").policy
    collect = vr.make_collect_fn(agent, pc, STEPS, 0.25, 1.0,
                                 frame_stack=fs)
    lanes, obs, goal = vk.vec_reset(pc, LANES)
    if fs:
        obs = vr.stack_init(obs, fs)
    (state, _, _), traj = collect(actor, (lanes, obs, goal),
                                  noise=torch.from_numpy(noise))
    return {"jax": {k: np.asarray(v) for k, v in jtraj.items()},
            "port": traj, "state": state, "fs": fs}


@pytest.mark.parametrize("field", FIELDS)
def test_collection_matches_jax(chunk, field):
    got, want = chunk["port"][field], chunk["jax"][field]
    assert tuple(got.shape) == want.shape
    if field in EXACT:
        equal(got, want, field)
    else:
        close(got, want, field, 1e-5 if field == "act" else TOL)


def test_collection_masks(chunk):
    traj = chunk["port"]
    store = traj["store"].numpy()
    assert not store[0].any()          # every lane starts an episode
    assert (~store[1:]).any()          # and a later one inside the chunk
    assert traj["episode_end"].numpy().sum() >= LANES
    if chunk["fs"]:
        assert traj["obs"].shape == (STEPS, LANES, chunk["fs"], *HW)
        # the stored next stack's older frames are the stack's newer ones
        assert torch.equal(traj["next_obs"][:, :, 0], traj["obs"][:, :, 1])
