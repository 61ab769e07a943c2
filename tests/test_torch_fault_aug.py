"""The port's sensor-fault transforms (dgvit_tpu_torch/envs/fault_aug.py)
and the fused loop's training-time augmentation
(make_collect_fn(fault_knobs=...), train_fused(fault_knobs=...)) against
the JAX package's, on the CPU.

The cases of tests/test_fault_aug.py are mirrored (not its sharded one).
`perturb_obs` is held to JAX's with JAX's own draws injected (its split
sequence: normals, uniforms, then the patch's y0 and x0 uniforms): each
knob alone and all five together, on (B, H, W) frames and (B, C, H, W)
stacks, within 1e-6 (fp32 on both sides, the same operations in the same
order; they agree bit for bit here), and the patch's zero set exactly.
One chunk of collection with knobs is held to JAX's make_collect_fn with
JAX's draws injected (the action noise of `fold_in(rng, t)`, the fault
draws of `fold_in(key, 101)` for obs and `fold_in(key, 102)` for
next_obs, the gate's uniforms when aug_prob < 1): every field within
1e-4 (actions 1e-5), the masks and flags exactly. A knob at 0.0 and
aug_prob 0.0 leave a collection and a whole fused round bit-identical to
the unaugmented ones.
"""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.envs import fault_aug as jfa
from dgvit_tpu.envs import jax_kinematic as jk
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu.train import vec_rollout as jvr
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import vec_kinematic as vk
from dgvit_tpu_torch.envs.fault_aug import (KNOB_KEYS, draw_faults,
                                            knobs_array, perturb_obs)
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.serve import make_action_fn
from dgvit_tpu_torch.train import fused_train as ft
from dgvit_tpu_torch.train import vec_rollout as vr

HW = (32, 40)
MODEL = {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
         "image_size": HW, "patch_size": (16, 20), "emb_dropout": 0.0}
RECORDS = default_records(seed=0)
TOL = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def frames(seed, shape):
    return t(jax.random.uniform(jax.random.PRNGKey(seed), shape))


def jax_fault_draws(key, shape):
    """The four draws JAX's perturb_obs makes from `key`
    (dgvit_tpu/envs/fault_aug.py:59-76)."""
    key, k = jax.random.split(key)
    n = jax.random.normal(k, shape)
    key, k = jax.random.split(key)
    u = jax.random.uniform(k, shape)
    _, k = jax.random.split(key)
    ky, kx = jax.random.split(k)
    return tuple(t(a) for a in (n, u, jax.random.uniform(ky, (shape[0],)),
                                jax.random.uniform(kx, (shape[0],))))


def tiny_dict(**over):
    d = {"model": dict(MODEL), "sac": {"batch_size": 4, "buffer_size": 128},
         "env": {"max_steps": 8},
         "train": {"pre_buffer": False, "pre_train": False, "save": False}}
    for k, v in over.items():
        d[k].update(v)
    return d


def tiny(**over):
    return Config.from_dict(tiny_dict(**over))


# --------------------------------------------------------------------------
# perturb_obs (tests/test_fault_aug.py:20, :32, :43, :62)
# --------------------------------------------------------------------------

def test_zero_knobs_bit_identical():
    for shape in ((3, 16, 20), (3, 4, 16, 20)):
        obs = frames(0, shape)
        out = perturb_obs(obs, knobs_array({}),
                          torch.Generator().manual_seed(1))
        assert torch.equal(out, obs)
        # a knob at 0.0 beside one that is on leaves its stage out
        d = draw_faults(shape, torch.Generator().manual_seed(2))
        grey = perturb_obs(obs, knobs_array({"greying": 0.5}), draws=d)
        both = perturb_obs(obs, knobs_array({"greying": 0.5,
                                             "obs_noise": 0.0}), draws=d)
        assert torch.equal(grey, both)


def test_knobs_array_order_and_validation():
    k = knobs_array({"patch_occlusion": 0.25, "obs_noise": 0.1})
    assert len(k) == 5 and KNOB_KEYS == jfa.KNOB_KEYS
    assert KNOB_KEYS.index("obs_noise") == 0
    np.testing.assert_allclose([k[0], k[3]], [0.1, 0.25], rtol=1e-6)
    # host floats holding JAX's f32 values
    assert all(isinstance(v, float) for v in k)
    np.testing.assert_array_equal(
        np.asarray(k, np.float32),
        np.asarray(jfa.knobs_array({"patch_occlusion": 0.25,
                                    "obs_noise": 0.1})))
    with pytest.raises(AssertionError, match="unknown fault knobs"):
        knobs_array({"nope": 1.0})


def test_patch_zeroes_one_contiguous_rectangle():
    obs = torch.ones((4, 32, 40))
    gen = torch.Generator().manual_seed(3)
    out = perturb_obs(obs, knobs_array({"patch_occlusion": 0.25}),
                      gen).numpy()
    for lane in out:
        zero_rows = np.flatnonzero((lane == 0).any(axis=1))
        zero_cols = np.flatnonzero((lane == 0).any(axis=0))
        assert (np.diff(zero_rows) == 1).all()
        assert (np.diff(zero_cols) == 1).all()
        assert (lane[np.ix_(zero_rows, zero_cols)] == 0).all()
        area = zero_rows.size * zero_cols.size / lane.size
        assert 0.15 < area < 0.35
    out1 = perturb_obs(obs, knobs_array({"patch_occlusion": 1.0}),
                       torch.Generator().manual_seed(3))
    assert (out1 == 0).all()


def test_greying_blends_toward_mid():
    out = perturb_obs(torch.zeros((2, 8, 10)),
                      knobs_array({"greying": 0.6})).numpy()
    np.testing.assert_allclose(out, 0.3, rtol=1e-6)


KNOB_CASES = [{"obs_noise": 50 / 255}, {"blur": 0.5}, {"occlusion": 0.25},
              {"patch_occlusion": 0.1}, {"greying": 0.6},
              {"obs_noise": 0.2, "blur": 0.5, "occlusion": 0.1,
               "patch_occlusion": 0.25, "greying": 0.3}]
KNOB_IDS = ["noise", "blur", "occlusion", "patch", "greying", "all5"]


@pytest.mark.parametrize("shape", [(3, *HW), (3, 2, *HW)],
                         ids=["frames", "stack2"])
@pytest.mark.parametrize("pt", KNOB_CASES, ids=KNOB_IDS)
def test_perturb_obs_matches_jax(pt, shape):
    obs = jax.random.uniform(jax.random.PRNGKey(0), shape)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jfa.perturb_obs(obs, key, jfa.knobs_array(pt)))
    got = perturb_obs(t(obs), knobs_array(pt),
                      draws=jax_fault_draws(key, shape)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    if "patch_occlusion" in pt or "occlusion" in pt:
        np.testing.assert_array_equal(got == 0, ref == 0)


def test_generator_draws_are_reproducible_and_paired():
    """The draws depend on the generator alone, not on the knobs: two
    settings from one seed share the noise realization."""
    obs = frames(1, (2, *HW))
    a = perturb_obs(obs, knobs_array({"obs_noise": 0.1}),
                    torch.Generator().manual_seed(5))
    b = perturb_obs(obs, knobs_array({"obs_noise": 0.1, "greying": 0.5}),
                    torch.Generator().manual_seed(5))
    np.testing.assert_allclose(b.numpy(), (a * 0.5 + 0.25).numpy(),
                               atol=1e-6)
    c = perturb_obs(obs, knobs_array({"obs_noise": 0.1}),
                    torch.Generator().manual_seed(6))
    assert not torch.equal(a, c)


# --------------------------------------------------------------------------
# collection with knobs against JAX make_collect_fn
# --------------------------------------------------------------------------

LANES, STEPS = 4, 8
FIELDS = ("obs", "act", "pobs", "next_pobs", "rew", "next_obs", "done",
          "episode_end", "store", "target", "collided")
EXACT = ("done", "episode_end", "store", "target", "collided")
AUG = {"patch_occlusion": 0.25, "obs_noise": 0.196}


def jax_collect_draws(rng, shape, next_shape, aug_prob):
    """JAX's draws of a chunk (vec_rollout.py:93-145): the action noise of
    each step, and the (obs, next_obs) fault draws from fold_in(key, 101)
    and fold_in(key, 102), each split into the gate's and the faults'."""
    acts, faults = [], []
    for step in range(STEPS):
        key = jax.random.fold_in(rng, step)
        acts.append(np.array(JAX_AGENT._row_noise_draw(
            jax.random.split(key)[0], LANES, 2)))
        pair = []
        for fold, shp in ((101, shape), (102, next_shape)):
            k_gate, k_pert = jax.random.split(jax.random.fold_in(key, fold))
            gate = (t(jax.random.uniform(k_gate, (LANES,)))
                    if aug_prob < 1.0 else None)
            pair.append((gate,) + jax_fault_draws(k_pert, shp))
        faults.append(tuple(pair))
    return t(np.stack(acts)), faults


JAX_AGENT = None


@pytest.fixture(scope="module", params=[(0, 1.0), (0, 0.5), (2, 0.5)],
                ids=["frames", "frames-p0.5", "stack2-p0.5"])
def aug_chunk(request):
    global JAX_AGENT
    fs, aug_prob = request.param
    model = dict(MODEL, patch_mode="channels") if fs else MODEL
    env = {"max_steps": 5}
    if fs:
        env.update(use_frame_stack=True, frame_stack=fs)
    jcfg = JaxConfig.from_dict({"model": model, "env": env})
    cfg = Config.from_dict({"model": model, "env": env})
    JAX_AGENT = JaxSACAgent(jcfg, row_noise=True)
    obs0 = np.zeros((1, fs, *HW) if fs else (1, *HW))
    params = jax_build_actor(jcfg).init(jax.random.PRNGKey(5), obs0,
                                        np.zeros((1, 2)))["params"]
    jc = jk.make_consts(world="rrc", records=RECORDS, image_hw=HW,
                        max_steps=5, seed=0)
    pc = vk.make_consts(world="rrc", records=RECORDS, image_hw=HW,
                        max_steps=5, seed=0, device="cpu")
    jcollect = jax.jit(jvr.make_collect_fn(
        JAX_AGENT, jc, STEPS, 0.25, 1.0, frame_stack=fs, fault_knobs=AUG,
        aug_prob=aug_prob))
    carry = jk.vec_reset(jc, LANES)
    if fs:
        carry = (carry[0], jvr.stack_init(carry[1], fs), carry[2])
    rng = jax.random.PRNGKey(21)
    _, jtraj = jcollect(params, carry, rng)
    shape = (LANES, fs, *HW) if fs else (LANES, *HW)
    noise, faults = jax_collect_draws(rng, shape, shape, aug_prob)

    agent = SACAgent(cfg, device="cpu")
    actor = make_action_fn(cfg, jax.tree_util.tree_map(np.asarray, params),
                           dtype=torch.float32, device="cpu").policy
    lanes, obs, goal = vk.vec_reset(pc, LANES)
    if fs:
        obs = vr.stack_init(obs, fs)
    out = {"jax": {k: np.asarray(v) for k, v in jtraj.items()}, "fs": fs,
           "aug_prob": aug_prob, "faults": faults}
    for name, kw in (("port", dict(fault_knobs=AUG, aug_prob=aug_prob)),
                     ("clean", {})):
        collect = vr.make_collect_fn(agent, pc, STEPS, 0.25, 1.0,
                                     frame_stack=fs, **kw)
        _, out[name] = collect(actor, (lanes, obs, goal),
                               noise=noise,
                               faults=faults if kw else None)
    return out


@pytest.mark.parametrize("field", FIELDS)
def test_augmented_collection_matches_jax(aug_chunk, field):
    got, want = aug_chunk["port"][field], aug_chunk["jax"][field]
    assert tuple(got.shape) == want.shape
    if field in EXACT:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 if field == "act" else 1e-4,
                                   err_msg=field)


def test_augmented_collection_perturbs_the_stored_frames(aug_chunk):
    """The first step starts from the same clean frames in both
    collections: the stored obs and next_obs differ from the clean
    collection's where a lane's gate opened, and with aug_prob 0.5 some
    lane-steps stay clean."""
    aug, clean = aug_chunk["port"], aug_chunk["clean"]
    for f in ("obs", "next_obs"):
        per_row = (aug[f][0] != clean[f][0]).flatten(1).any(-1)
        assert bool(per_row.any()), f
    per_row = (aug["obs"][0] != clean["obs"][0]).flatten(1).any(-1)
    if aug_chunk["aug_prob"] >= 1.0:
        assert bool(per_row.all())
    else:
        opened = aug_chunk["faults"][0][0][0] < aug_chunk["aug_prob"]
        assert torch.equal(per_row, opened)


# --------------------------------------------------------------------------
# collection and the fused loop (tests/test_fault_aug.py:97-132)
# --------------------------------------------------------------------------

def collect_once(fault_knobs, aug_prob=1.0, seed=0):
    cfg = tiny()
    agent = SACAgent(cfg, device="cpu")
    actor = agent.init_state(seed).actor
    consts = vk.make_consts(world="rrc", records=RECORDS, image_hw=HW,
                            max_steps=8, device="cpu")
    collect = vr.make_collect_fn(agent, consts, 6, cfg.env.linear_cmd_scale,
                                 cfg.env.angular_cmd_scale,
                                 fault_knobs=fault_knobs, aug_prob=aug_prob)
    _, traj = collect(actor, vk.vec_reset(consts, 4),
                      torch.Generator().manual_seed(seed),
                      fault_gen=torch.Generator().manual_seed(seed + 1))
    return {k: v.numpy() for k, v in traj.items()}


def test_collect_stores_perturbed_frames():
    traj = collect_once({"patch_occlusion": 1.0})
    assert (traj["obs"] == 0).all()
    assert (traj["next_obs"] == 0).all()
    assert np.isfinite(traj["rew"]).all()
    clean = collect_once(None)
    assert (clean["obs"] != 0).any()


def test_aug_prob_zero_gates_everything():
    traj = collect_once({"patch_occlusion": 1.0}, aug_prob=0.0)
    clean = collect_once(None)
    for k in traj:
        np.testing.assert_array_equal(traj[k], clean[k], err_msg=k)
    # a knob at 0.0 is the clean collection too
    zero = collect_once({"obs_noise": 0.0, "greying": 0.0})
    for k in zero:
        np.testing.assert_array_equal(zero[k], clean[k], err_msg=k)


def test_aug_prob_mixes_clean_and_perturbed():
    traj = collect_once({"greying": 1.0}, aug_prob=0.5, seed=1)
    rows = traj["obs"].reshape(-1, *traj["obs"].shape[2:])
    greyed = np.array([(np.abs(r - 0.5) < 1e-6).all() for r in rows])
    assert greyed.any() and not greyed.all()


def fused(tmp_path, **kw):
    args = dict(n_envs=4, chunk=6, rounds=2, rounds_per_dispatch=2,
                updates_per_round=1, ring_capacity=64, device="cpu")
    args.update(kw)
    return ft.train_fused(tiny(), out_dir=str(tmp_path), **args)


def test_train_fused_with_aug(tmp_path, capsys):
    out = fused(tmp_path, fault_knobs={"patch_occlusion": 0.25,
                                       "obs_noise": 0.1}, aug_prob=0.5)
    assert out["rounds"] == 2 and out["env_steps"] == 2 * 4 * 6
    assert "sensor-fault augmentation: {'patch_occlusion': 0.25, " \
        "'obs_noise': 0.1} (prob 0.5)" in capsys.readouterr().out
    ring = out["ring"]
    stored = ring.obs[:ring.size].flatten(1)
    # depth frames are strictly positive, so zeros are the patch
    patched = (stored == 0).any(1)
    assert bool(patched.any()) and not bool(patched.all())


def test_aug_prob_zero_round_equals_the_unaugmented_round(tmp_path):
    """aug_prob 0.0: the fault draws come from their own generator and
    every gate is shut, so a whole run (collection, ring, updates) is the
    unaugmented run bit for bit."""
    a = fused(tmp_path / "a")
    b = fused(tmp_path / "b", fault_knobs={"patch_occlusion": 0.5,
                                           "obs_noise": 0.3},
              aug_prob=0.0)
    for f in ft.RING_FIELDS:
        assert torch.equal(getattr(a["ring"], f), getattr(b["ring"], f)), f
    for x, y in zip(a["state"].actor.parameters(),
                    b["state"].actor.parameters()):
        assert torch.equal(x, y)


def test_aug_leaves_the_action_noise_and_minibatches(tmp_path):
    """With knobs the round's action noise and minibatch draws stay those
    of the unaugmented round: only the frames change."""
    a = fused(tmp_path / "a", rounds=1, rounds_per_dispatch=1)
    b = fused(tmp_path / "b", rounds=1, rounds_per_dispatch=1,
              fault_knobs={"greying": 0.9})
    ra, rb = a["ring"], b["ring"]
    assert not torch.equal(ra.obs, rb.obs)
    # greying to 0.9 leaves a frame a function of its clean self, and the
    # first step's action acts on the carried reset frames in both
    np.testing.assert_allclose(rb.obs[:4].numpy(),
                               (ra.obs[:4] * np.float32(0.1)
                                + np.float32(0.45)).numpy(), atol=1e-6)


def test_fused_cli_parses_aug(tmp_path, capsys):
    import yaml

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny().to_dict()))
    common = ["--config", str(cfg_path), "--out", str(tmp_path),
              "--n-envs", "2", "--chunk", "4", "--rounds", "1",
              "--rounds-per-dispatch", "1", "--ring-capacity", "32",
              "--device", "cpu"]
    ft.main([*common, "--aug", "patch_occlusion=0.25", "--aug",
             "obs_noise=0.1", "--aug-prob", "0.5"])
    out = capsys.readouterr().out
    assert "(prob 0.5)" in out and "rounds: 1" in out
    for bad in ("patch_occlusion", "obs_noise="):
        with pytest.raises(SystemExit):
            ft.main([*common, "--aug", bad])
    with pytest.raises(AssertionError, match="unknown fault knobs"):
        ft.main([*common, "--aug", "fog=0.5"])
