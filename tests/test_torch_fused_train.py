"""The port's on-device training loop (dgvit_tpu_torch/train/fused_train.py)
and the batched loops beside it (train_vec, run_eval_vec) against the JAX
package's, on the CPU, at a tiny geometry (32x40 frames, one block, latent
32, emb-dropout 0).

The ring is held bit-equal to JAX's `ring_write` on the same rows. One
whole round (2 lanes, chunk 6, 3 updates, batch 4, ring 32) runs from a
JAX train state carried over by `sac_state_from_jax`, with JAX's draws
injected: the action noise of each step (`fold_in(k_coll, t)` -> split ->
the actor's row noise), each update's ring rows and expert rows (the
round's `k_upd` split U ways) and each update's row noise (from the
state's key and counter, as tests/test_torch_sac.py derives it). The
round's stats must match (counts exactly, sums and metrics within rtol
1e-4, atol 1e-5), its ring within 1e-4 (images) and 1e-5 (actions), and
the parameters after it under test_torch_sac.py's two-level check: nearly
every element within atol 5e-6 / rtol 1e-4 and every element within 2.2
x lr per update (a near-zero gradient element may flip its Adam step).
The plain and the guided round both, and both again with on-device PER
(JAX's uniform draws of `per_sample` injected as well): the priorities
after the round within rtol 1e-4 / atol 1e-6 of JAX's (each |td| is
within the metrics' tolerance), the running max within rtol 1e-4.

The end-to-end runs mirror tests/test_fused_train.py (not its sharded
cases) and tests/test_jax_kinematic.py's train_vec and run_eval_vec
cases; the sensor-fault flavours run (tests/test_torch_fault_aug.py holds
them to JAX).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.envs import jax_kinematic as jk
from dgvit_tpu.replay import device_per as jper
from dgvit_tpu.train import fused_train as jft
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs import vec_kinematic as vk
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from dgvit_tpu_torch.replay.device_per import per_init
from dgvit_tpu_torch.train import evaluate as port_evaluate
from dgvit_tpu_torch.train import fused_train as ft
from dgvit_tpu_torch.train import vec_rollout as vr

HW = (32, 40)
MODEL = {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
         "image_size": HW, "patch_size": (16, 20), "emb_dropout": 0.0}
LANES, CHUNK, UPDATES, BATCH, CAP = 2, 6, 3, 4, 32
N_EXPERT = 9          # 12 rows in the ring: floor(9 / 12 * 4) = 3 valid
LR = 1e-3
STAT_TOL = dict(rtol=1e-4, atol=1e-5)


def cfg_dict(**over):
    d = {"model": dict(MODEL),
         "sac": {"batch_size": BATCH, "buffer_size": 128},
         "env": {"max_steps": 8},
         "train": {"pre_buffer": False, "pre_train": False, "save": False}}
    for k, v in over.items():
        d[k].update(v)
    return d


def tiny(**over):
    return Config.from_dict(cfg_dict(**over))


RECORDS = default_records(seed=0)


def rows_of(seed, n, hw=HW):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"obs": f(n, *hw), "act": f(n, 2), "pobs": f(n, 2),
            "next_pobs": f(n, 2), "rew": f(n), "next_obs": f(n, *hw),
            "done": (rng.uniform(size=n) < 0.3).astype(np.float32)}


def as_torch(rows):
    return {k: torch.from_numpy(v) for k, v in rows.items()}


def two_level_close(port, ref, lr):
    for name, t in port.items():
        x, y = t.detach().float().numpy(), np.asarray(ref[name])
        close = np.isclose(x, y, atol=5e-6, rtol=1e-4)
        assert close.mean() >= 0.995, \
            f"{name}: {(1 - close.mean()) * 100:.2f}% elements off"
        assert np.abs(x - y).max() <= 2.2 * lr, name


def write_demos(path, n, hw=HW, seed=0):
    """A demo npz in the reference's recording schema (goal (N, 4))."""
    rng = np.random.default_rng(seed)
    np.savez(path,
             obs=rng.uniform(0, 1, (n, *hw)).astype(np.float32),
             act=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
             goal=rng.uniform(-1, 1, (n, 4)).astype(np.float32),
             reward=rng.normal(size=(n,)).astype(np.float32),
             next_obs=rng.uniform(0, 1, (n, *hw)).astype(np.float32),
             next_goal=rng.uniform(-1, 1, (n, 4)).astype(np.float32),
             done=(np.arange(n) % 5 == 4).astype(np.float32))


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------

def test_ring_wraparound_and_sampling():
    ring = ft.ring_init(8, (4, 5), pdim=2, device="cpu")
    mk = lambda n, base: as_torch({
        "obs": np.full((n, 4, 5), base, np.float32),
        "act": np.full((n, 2), base, np.float32),
        "pobs": np.zeros((n, 2), np.float32),
        "next_pobs": np.zeros((n, 2), np.float32),
        "rew": np.arange(base, base + n, dtype=np.float32),
        "next_obs": np.zeros((n, 4, 5), np.float32),
        "done": np.zeros((n,), np.float32)})
    ft.ring_write(ring, mk(6, 0))
    assert ring.cursor == 6 and ring.size == 6
    ft.ring_write(ring, mk(4, 10))      # wraps: rows 6, 7, then 0, 1
    assert ring.cursor == 10 and ring.size == 8
    rews = ring.rew.numpy()
    np.testing.assert_array_equal(rews[6:8], [10, 11])
    np.testing.assert_array_equal(rews[0:2], [12, 13])
    np.testing.assert_array_equal(rews[2:6], [2, 3, 4, 5])
    batch = ft.ring_sample(ring, torch.Generator().manual_seed(0), 16)
    assert batch["rew"].shape == (16, 1) and batch["done"].shape == (16, 1)
    assert batch["obs"].shape == (16, 4, 5)
    assert np.isin(batch["rew"].numpy()[:, 0], rews).all()


def test_sample_respects_partial_fill():
    ring = ft.ring_init(64, (4, 5), device="cpu")
    rows = rows_of(1, 3, (4, 5))
    rows["rew"] = np.asarray([7.0, 8.0, 9.0], np.float32)
    ft.ring_write(ring, as_torch(rows))
    batch = ft.ring_sample(ring, torch.Generator().manual_seed(1), 64)
    # only the 3 written rows, never the zeros of the rest
    assert set(batch["rew"].numpy()[:, 0]) == {7.0, 8.0, 9.0}


def test_ring_matches_jax_ring_write():
    """Three writes (the third wraps) leave the ring bit-equal to JAX's."""
    ring = ft.ring_init(16, HW, device="cpu")
    jring = jft.ring_init(16, HW)
    for seed, n in ((0, 6), (1, 7), (2, 9)):
        rows = rows_of(seed, n)
        ft.ring_write(ring, as_torch(rows))
        jring = jft.ring_write(jring, {k: jnp.asarray(v)
                                       for k, v in rows.items()})
    assert ring.cursor == int(jring.cursor) == 22
    for f in ft.RING_FIELDS:
        np.testing.assert_array_equal(getattr(ring, f).numpy(),
                                      np.asarray(getattr(jring, f)), f)
    idx = torch.as_tensor([0, 5, 15, 3])
    got, want = ft.ring_gather(ring, idx), jft.ring_gather(jring, idx.numpy())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_ring_save_load_roundtrip(tmp_path):
    ring = ft.ring_init(8, (4, 5), pdim=2, device="cpu")
    ft.ring_write(ring, as_torch(rows_of(0, 6, (4, 5))))
    path = str(tmp_path / "ring.npz")
    ft.ring_save(ring, path, chunk_rows=3)     # the multi-slice path
    back = ft.ring_load(path, ft.ring_init(8, (4, 5), pdim=2, device="cpu"))
    assert back is not None and back.cursor == 6
    for f in ft.RING_FIELDS:
        assert torch.equal(getattr(back, f), getattr(ring, f)), f
    # the JAX package reads the port's snapshot
    jback = jft.ring_load(path, jft.ring_init(8, (4, 5), pdim=2))
    np.testing.assert_array_equal(np.asarray(jback.obs), ring.obs.numpy())
    # another capacity or image size: None, and the ring is left alone
    cold = ft.ring_init(16, (4, 5), pdim=2, device="cpu")
    assert ft.ring_load(path, cold) is None and cold.cursor == 0
    assert ft.ring_load(path, ft.ring_init(8, (6, 5), pdim=2,
                                           device="cpu")) is None


def test_expert_rows_matches_the_reference_count():
    for n, size, b in ((9, 12, 4), (24, 12, 4), (2600, 1024, 256),
                       (160, 8192, 256), (7, 3, 5)):
        assert ft.expert_rows(n, size, b) == \
            SACAgent.expert_batch_size(n, size, b)


# --------------------------------------------------------------------------
# one whole round against JAX make_fused_round
# --------------------------------------------------------------------------

def row_noise(jagent, rng, itera, rows, n_split):
    key = jax.random.fold_in(rng, itera)
    keys = jax.random.split(key, n_split)
    a = jagent.cfg.sac.action_dim
    return tuple(np.array(jagent._row_noise_draw(
        jax.random.split(keys[i], 3)[0], rows, a)) for i in (0, 2))


def jax_draws(jagent, state, rng, size, guided, prioritized=False):
    """The draws of JAX's first round (fused_train.py:198, :247-265 and
    the update's row noise)."""
    _, k_coll, k_upd = jax.random.split(rng, 3)
    act = np.stack([np.array(jagent._row_noise_draw(
        jax.random.split(jax.random.fold_in(k_coll, t))[0], LANES, 2))
        for t in range(CHUNK)])
    ring_idx, expert_idx, per_u, noise = [], [], [], []
    for u, k in enumerate(jax.random.split(k_upd, UPDATES)):
        if prioritized:
            ks, ke, _ = jax.random.split(k, 3)
            per_u.append(np.array(jax.random.uniform(ks, (BATCH,))))
        elif guided:
            ks, ke = jax.random.split(k)
        else:
            ks = k
        if guided:
            expert_idx.append(np.array(jax.random.randint(
                ke, (BATCH,), 0, N_EXPERT)))
        ring_idx.append(np.array(jax.random.randint(ks, (BATCH,), 0, size)))
        noise.append(row_noise(jagent, state.rng, int(state.itera) + u,
                               2 * BATCH if guided else BATCH,
                               5 if guided else 3))
    t = lambda x: torch.from_numpy(np.asarray(x))
    return {"act_noise": t(act), "ring_idx": t(ring_idx),
            "expert_idx": t(expert_idx) if guided else None,
            "per_u": t(per_u) if prioritized else None,
            "update_noise": [tuple(t(n) for n in pair) for pair in noise]}


def expert_corpus(tmp_path):
    write_demos(str(tmp_path / "demo_bot_1.npz"), N_EXPERT, seed=3)
    from dgvit_tpu_torch.train.train_rl import load_expert_dataset
    return ft.stage_expert(load_expert_dataset(
        str(tmp_path / "demo_bot_*.npz")), 0, "cpu")


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """JAX's first fused round, plain and guided, each with uniform and
    with prioritized replay, from a carried state, and the port's with
    JAX's draws."""
    jcfg = JaxConfig.from_dict(cfg_dict(sac={"guidence_weight": 3.0}))
    jagent = JaxSACAgent(jcfg, row_noise=True)
    batch = {k: v for k, v in rows_of(9, 6).items()}
    batch["rew"], batch["done"] = batch["rew"][:, None], batch["done"][:, None]
    s1, _ = jagent.learn(jagent.init_state(3), batch)
    carried = jax.tree_util.tree_map(np.asarray, s1)
    jconsts = jk.make_consts(world="rrc", records=RECORDS, image_hw=HW,
                             max_steps=8)
    consts = vk.make_consts(world="rrc", records=RECORDS, image_hw=HW,
                            max_steps=8, device="cpu")
    expert = expert_corpus(tmp_path_factory.mktemp("demos"))
    jexpert = {k: jnp.asarray(v.numpy()) for k, v in expert.items()}
    agent = SACAgent(tiny(sac={"guidence_weight": 3.0}), device="cpu")
    rng = jax.random.PRNGKey(11)
    out = {}
    for guided, per in FLAVOURS:
        jrun = jft.make_fused_round(jagent, jconsts, LANES, CHUNK, UPDATES,
                                    BATCH, 0.25, 1.0, guided=guided,
                                    prioritized=per)
        st = jax.tree_util.tree_map(jnp.asarray, carried)
        draws = jax_draws(jagent, st, rng, LANES * CHUNK, guided, per)
        res = jrun(st, jk.vec_reset(jconsts, LANES), jft.ring_init(CAP, HW),
                   rng, jnp.arange(1), jper.per_init(CAP) if per else None,
                   jexpert if guided else None)
        run = ft.make_fused_round(agent, consts, LANES, CHUNK, UPDATES,
                                  BATCH, 0.25, 1.0, guided=guided,
                                  prioritized=per)
        got = run(sac_state_from_jax(agent, carried),
                  vk.vec_reset(consts, LANES),
                  ft.ring_init(CAP, HW, device="cpu"), [0],
                  expert if guided else None, [draws],
                  per=per_init(CAP, "cpu") if per else None)
        js, jcarry, jring, jstats = res[:4]
        state, carry, ring, stats = got[:4]
        out[guided, per] = dict(
            jax=jax.tree_util.tree_map(np.asarray, js), port=state,
            jstats={k: np.asarray(v) for k, v in jstats.items()},
            stats=stats, jring=jring, ring=ring, jcarry=jcarry, carry=carry,
            jper=res[4] if per else None, per=got[4] if per else None)
    return out


FLAVOURS = [(False, False), (True, False), (False, True), (True, True)]
FLAVOUR_IDS = ["plain", "guided", "plain-per", "guided-per"]


@pytest.mark.parametrize("guided", FLAVOURS, ids=FLAVOUR_IDS)
def test_round_stats_match_jax(rounds, guided):
    r = rounds[guided]
    if guided[1]:
        assert "entropy" not in r["stats"]
    stats, jstats = r["stats"], r["jstats"]
    assert set(stats) == set(jstats)
    for k in ("goals", "collisions", "episodes", "buffer"):
        assert stats[k][0] == float(jstats[k][0]), k
    for k in set(stats) - {"goals", "collisions", "episodes", "buffer"}:
        np.testing.assert_allclose(stats[k], jstats[k], err_msg=k,
                                   **STAT_TOL)
    assert stats["buffer"][0] == LANES * CHUNK
    if guided[0]:
        assert stats["n_expert"][0] == 3.0


@pytest.mark.parametrize("guided", FLAVOURS[2:], ids=FLAVOUR_IDS[2:])
def test_round_priorities_match_jax(rounds, guided):
    """The round's new rows at the max priority, then every update's rows
    at (|td| + 1e-6)^0.6: JAX's state after the round."""
    per, jp = rounds[guided]["per"], rounds[guided]["jper"]
    np.testing.assert_allclose(per.prios.numpy(), np.asarray(jp.prios),
                               rtol=1e-4, atol=1e-6)
    assert per.max_p.item() == pytest.approx(float(jp.max_p), rel=1e-4)
    written = per.prios.numpy()[:LANES * CHUNK]
    assert (per.prios.numpy()[LANES * CHUNK:] == 0).all()
    assert len(np.unique(written)) > 1      # the updates moved some rows


@pytest.mark.parametrize("guided", FLAVOURS, ids=FLAVOUR_IDS)
def test_round_ring_matches_jax(rounds, guided):
    ring, jring = rounds[guided]["ring"], rounds[guided]["jring"]
    assert ring.cursor == int(jring.cursor) == LANES * CHUNK
    for f in ft.RING_FIELDS:
        tol = 1e-5 if f == "act" else 1e-4
        np.testing.assert_allclose(getattr(ring, f).numpy(),
                                   np.asarray(getattr(jring, f)), atol=tol,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(ring.done.numpy(), np.asarray(jring.done))
    # the lanes carry on where JAX's do
    state, jstate = rounds[guided]["carry"][0], rounds[guided]["jcarry"][0]
    np.testing.assert_array_equal(state.rec_idx.numpy(),
                                  np.asarray(jstate.rec_idx))
    np.testing.assert_array_equal(state.steps.numpy(),
                                  np.asarray(jstate.steps))
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x),
                               atol=1e-4)


@pytest.mark.parametrize("guided", FLAVOURS, ids=FLAVOUR_IDS)
@pytest.mark.parametrize("which", ["actor", "critic", "critic_target"])
def test_round_params_match_jax(rounds, guided, which):
    r = rounds[guided]
    assert r["port"].itera == int(r["jax"].itera) == 1 + UPDATES
    two_level_close(dict(getattr(r["port"], which).named_parameters()),
                    params_from_jax(getattr(r["jax"], f"{which}_params")),
                    lr=LR * UPDATES)
    np.testing.assert_allclose(r["port"].log_alpha.item(),
                               float(r["jax"].log_alpha), **STAT_TOL)


# --------------------------------------------------------------------------
# end-to-end runs
# --------------------------------------------------------------------------

def fused(tmp_path, cfg=None, **kw):
    args = dict(n_envs=2, chunk=6, rounds=2, rounds_per_dispatch=2,
                updates_per_round=1, ring_capacity=64, device="cpu")
    args.update(kw)
    return ft.train_fused(cfg or tiny(env={"max_steps": 4}),
                          out_dir=str(tmp_path), **args)


def jsonl_rows(tmp_path, prefix):
    path = next(tmp_path.glob(f"{prefix}_*.jsonl"))
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


def test_train_fused_end_to_end(tmp_path):
    cfg = tiny(env={"max_steps": 10}, train={"save": True})
    out = fused(tmp_path, cfg, rounds=4, updates_per_round=2)
    assert out["rounds"] == 4 and out["env_steps"] == 4 * 2 * 6
    # the first round fills the ring past the batch: every round updates
    assert out["updates"] == 8
    assert out["ring"].cursor == 48
    rows = jsonl_rows(tmp_path, "train_fused")
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert [r["buffer"] for r in rows] == [12.0, 24.0, 36.0, 48.0]
    assert all(np.isfinite(r["qf1_loss"]) for r in rows)
    assert list((tmp_path / "checkpoints").glob("step_*"))


def test_train_fused_warm_ring_resume(tmp_path):
    cfg = tiny(env={"max_steps": 4}, train={"save": True})
    out1 = fused(tmp_path, cfg, ring_snapshot_every=1)
    snap = tmp_path / "checkpoints" / "ring_latest.npz"
    back = ft.ring_load(str(snap), ft.ring_init(64, HW, device="cpu"))
    assert back.cursor == out1["env_steps"] == 24
    for f in ft.RING_FIELDS:
        assert torch.equal(getattr(back, f), getattr(out1["ring"], f)), f
    fused(tmp_path, cfg, rounds=4, resume=True, ring_snapshot_every=1)
    by_round = {r["step"]: r for r in jsonl_rows(tmp_path, "train_fused")}
    assert by_round[3]["buffer"] == 36.0   # 24 warm rows + 12 new
    # another geometry: a cold ring, not a crash
    out3 = fused(tmp_path, cfg, rounds=5, rounds_per_dispatch=1,
                 ring_capacity=32, resume=True)
    assert out3["rounds"] == 5 and out3["ring"].cursor == 12


def test_train_fused_resume_counters(tmp_path):
    cfg = tiny(env={"max_steps": 4}, train={"save": True})
    out1 = fused(tmp_path, cfg)
    assert out1["rounds"] == 2 and out1["updates"] == 2
    out2 = fused(tmp_path, cfg, rounds=4, resume=True)
    assert out2["rounds"] == 4
    assert out2["episodes"] >= out1["episodes"]
    assert out2["updates"] == out1["updates"] + 2
    rows = jsonl_rows(tmp_path, "train_fused")
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert rows[-1]["episodes"] == out2["episodes"]


def test_segments_do_not_change_the_draws(tmp_path):
    """Round r draws from step_key(seed, r) alone, so the split into
    segments (and a resume between them) leaves the run as it was."""
    one = fused(tmp_path / "a", rounds=4, rounds_per_dispatch=4)
    four = fused(tmp_path / "b", rounds=4, rounds_per_dispatch=1)
    assert one["updates"] == four["updates"] == 4
    for f in ft.RING_FIELDS:
        assert torch.equal(getattr(one["ring"], f),
                           getattr(four["ring"], f)), f
    for a, b in zip(one["state"].actor.parameters(),
                    four["state"].actor.parameters()):
        assert torch.equal(a, b)


def test_train_fused_max_episodes(tmp_path):
    out = fused(tmp_path, rounds=100, max_episodes=3)
    assert out["episodes"] >= 3
    assert out["rounds"] < 100


def test_train_fused_channels(tmp_path):
    cfg = tiny(model={"patch_mode": "channels"},
               env={"max_steps": 8, "use_frame_stack": True,
                    "frame_stack": 2})
    out = fused(tmp_path, cfg, rounds=3, rounds_per_dispatch=3)
    assert out["rounds"] == 3 and out["updates"] == 3
    assert out["ring"].obs.shape == (64, 2, *HW)
    # a stored stack's newest frame is the next stack's second-newest
    ring = out["ring"]
    assert torch.equal(ring.next_obs[:36, 0], ring.obs[:36, 1])


def test_train_fused_expert_guidance(tmp_path):
    write_demos(str(tmp_path / "demo_bot_1.npz"), 24)
    cfg = tiny(sac={"guidence_weight": 3.0}, train={"pre_buffer": True})
    out = fused(tmp_path, cfg, rounds=3, rounds_per_dispatch=3,
                updates_per_round=2, expert_glob=str(tmp_path / "*.npz"))
    assert out["rounds"] == 3 and out["updates"] == 6
    rows = jsonl_rows(tmp_path, "train_fused")
    assert all(np.isfinite(r["qf1_loss"]) for r in rows)


def test_dead_run_detector_aborts(tmp_path):
    cfg = tiny(sac={"nan_guard": True, "lr_critic": 1e12, "lr_actor": 1e12})
    out = fused(tmp_path, cfg, n_envs=4, chunk=8, rounds=40,
                updates_per_round=2, dead_segments_abort=2)
    assert out["aborted_dead"] is True
    assert out["rounds"] < 40


@pytest.mark.parametrize("flavour", ["launcher_aug", "fault_knobs",
                                     "aug_prob"])
def test_unported_flavours_raise_by_name(tmp_path, flavour):
    """The sensor-fault flavours that raised by name before they were
    ported now run: the launcher's --aug, train_fused's fault_knobs, and
    aug_prob below 1 (tests/test_torch_fault_aug.py holds them to JAX)."""
    cfg = tiny(env={"max_steps": 4})
    if flavour == "launcher_aug":
        from dgvit_tpu_torch.examples import reference_scale_run as rsr

        s = rsr.main(["--fused", "--aug", "patch_occlusion=0.25",
                      "--episodes", "1", "--eval-episodes", "2",
                      "--n-envs", "2", "--chunk", "4", "--device", "cpu",
                      "--out", str(tmp_path)], base=cfg)
        assert s["aug"] == {"patch_occlusion": 0.25} and s["aug_prob"] == 1.0
        assert list(tmp_path.glob("train_fused_*.jsonl"))
        return
    kw = ({"fault_knobs": {"obs_noise": 0.2}} if flavour == "fault_knobs"
          else {"fault_knobs": {"greying": 0.5}, "aug_prob": 0.5})
    out = fused(tmp_path, cfg, **kw)
    assert out["rounds"] == 2 and out["updates"] == 2
    assert not torch.equal(out["ring"].obs, fused(
        tmp_path / "clean", cfg)["ring"].obs)


def per_cfg(**over):
    cfg = tiny(**over)
    cfg.sac.prioritized_replay = True
    return cfg


def test_train_fused_prioritized(tmp_path):
    """Mirrors tests/test_device_per.py's train_fused_prioritized: the run
    ends with every written row's priority set and some moved off the
    write-time max by the updates."""
    out = fused(tmp_path, per_cfg(env={"max_steps": 10}), rounds=4,
                rounds_per_dispatch=2, updates_per_round=2)
    assert out["rounds"] == 4 and out["updates"] == 8
    prios = out["per"].prios.numpy()
    assert (prios[:48] > 0).all() and (prios[48:] == 0).all()
    assert len(np.unique(prios[:48])) > 1
    assert out["per"].max_p.item() >= 1.0
    rows = jsonl_rows(tmp_path, "train_fused")
    assert all(np.isfinite(r["qf1_loss"]) for r in rows)


def test_train_fused_warm_ring_resume_per(tmp_path):
    """Mirrors tests/test_fused_train.py:121: after a warm resume under PER
    the restored rows come back at the max priority (1 here: the first
    run's max is not saved) and the run goes on."""
    cfg = per_cfg(env={"max_steps": 4}, train={"save": True})
    out1 = fused(tmp_path, cfg, rounds=1, rounds_per_dispatch=1,
                 ring_snapshot_every=1)
    assert (tmp_path / "checkpoints" / "ring_latest.npz").exists()
    seen = {}
    real = ft.per_on_write

    def spy(per, idx):
        seen.setdefault("first", (per.prios.clone(), idx.clone()))
        return real(per, idx)

    ft.per_on_write = spy
    try:
        out2 = fused(tmp_path, cfg, rounds=2, rounds_per_dispatch=1,
                     resume=True, ring_snapshot_every=0)
    finally:
        ft.per_on_write = real
    before, idx = seen["first"]
    assert torch.equal(idx, torch.arange(12)) and (before == 0).all()
    assert out2["rounds"] == 2 and out2["updates"] > out1["updates"]
    assert (out2["per"].prios.numpy()[:24] > 0).all()


def test_train_vec_prioritized(tmp_path, monkeypatch):
    """train_vec with PER: the host sum-tree buffer, learn_per, and the
    sampled rows' priorities updated after each update."""
    from dgvit_tpu_torch.replay import PrioritizedReplayBuffer

    calls = []
    real = PrioritizedReplayBuffer.update_priorities

    def spy(self, idx, prios):
        calls.append((np.asarray(idx).copy(), np.asarray(prios).copy()))
        return real(self, idx, prios)

    monkeypatch.setattr(PrioritizedReplayBuffer, "update_priorities", spy)
    cfg = per_cfg(sac={"buffer_size": 256, "nan_guard": True},
                  env={"max_steps": 10})
    out = vr.train_vec(cfg, out_dir=str(tmp_path), n_envs=2, chunk=6,
                       total_env_steps=24, updates_per_chunk=2, device="cpu")
    assert out["updates"] == len(calls) >= 2
    for idx, prios in calls:
        assert idx.shape == prios.shape == (BATCH,)
        assert np.isfinite(prios).all() and (prios >= 1e-6).all()
    rows = jsonl_rows(tmp_path, "train_vec")
    assert "entropy" not in rows[-1] and np.isfinite(rows[-1]["qf1_loss"])


def test_train_vec(tmp_path):
    cfg = tiny(sac={"buffer_size": 512}, env={"max_steps": 10},
               train={"save": True})
    out = vr.train_vec(cfg, out_dir=str(tmp_path), n_envs=2, chunk=6,
                       total_env_steps=24, updates_per_chunk=2, device="cpu")
    assert out["env_steps"] == 24
    assert out["updates"] >= 2
    assert jsonl_rows(tmp_path, "train_vec")
    assert list((tmp_path / "checkpoints").glob("step_*"))


def test_train_vec_resume(tmp_path):
    """A resumed train_vec takes its counters from the JSONL: the chunk
    steps go on, `total_env_steps` counts the whole run, and the next
    chunk draws from step_key(seed, chunk)."""
    cfg = tiny(sac={"buffer_size": 256}, env={"max_steps": 10},
               train={"save": True})
    kw = dict(out_dir=str(tmp_path), n_envs=2, chunk=6, updates_per_chunk=1,
              device="cpu")
    first = vr.train_vec(cfg, total_env_steps=24, **kw)
    out = vr.train_vec(cfg, total_env_steps=36, resume=True, **kw)
    rows = jsonl_rows(tmp_path, "train_vec")
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert [r["env_steps"] for r in rows] == [12, 24, 36]
    assert out["env_steps"] == 36
    assert out["episodes"] == rows[-1]["episodes"] >= first["episodes"]
    assert out["updates"] > first["updates"]


def test_train_vec_channels(tmp_path):
    cfg = tiny(model={"patch_mode": "channels"}, sac={"buffer_size": 256},
               env={"max_steps": 8, "use_frame_stack": True,
                    "frame_stack": 2})
    out = vr.train_vec(cfg, out_dir=str(tmp_path), n_envs=2, chunk=6,
                       total_env_steps=24, updates_per_chunk=1, device="cpu")
    assert out["env_steps"] == 24 and out["updates"] >= 1


@pytest.fixture(scope="module")
def actor_params():
    from dgvit_tpu.models import build_actor as jax_build_actor
    actor = jax_build_actor(JaxConfig.from_dict(cfg_dict()))
    return jax.tree_util.tree_map(np.asarray, actor.init(
        jax.random.PRNGKey(3), np.zeros((1, *HW)), np.zeros((1, 2)))["params"])


def test_run_eval_vec_matches_host_run_eval(tmp_path, actor_params):
    cfg = tiny(env={"max_steps": 30})
    n = 8
    # the batched env draws its records from the config's seed
    env = KinematicNavEnv(default_records(seed=cfg.train.seed)[:n],
                          image_hw=HW)
    host = port_evaluate.run_eval(cfg, env, actor_params, max_episodes=n,
                                  out_dir=str(tmp_path / "h"), device="cpu")
    vec = port_evaluate.run_eval_vec(cfg, actor_params, max_episodes=n,
                                     world="rrc", out_dir=str(tmp_path / "v"),
                                     device="cpu")
    assert abs(host["successes"] - vec["successes"]) <= 1
    assert abs(host["collisions"] - vec["collisions"]) <= 1
    assert (tmp_path / "v" / "testing_data.txt").exists()


@pytest.mark.parametrize("world, steps", [("rrc", 30), ("randm4", 40)])
def test_run_eval_vec_matches_jax(tmp_path, actor_params, world, steps):
    """Lanes of the port's batched env against JAX's run_eval_vec: the
    same successes, collisions (6 and 1 of 8 here) and durations."""
    from dgvit_tpu.train import evaluate as jax_evaluate

    cfg = tiny(env={"max_steps": steps})
    jcfg = JaxConfig.from_dict(cfg_dict(env={"max_steps": steps}))
    ref = jax_evaluate.run_eval_vec(jcfg, actor_params, 8, world,
                                    str(tmp_path / "j"), "m")
    out = port_evaluate.run_eval_vec(cfg, actor_params, 8, world,
                                     str(tmp_path / "p"), "m", device="cpu")
    for k in ("successes", "collisions", "success_rate", "durations",
              "world_seed"):
        assert out[k] == ref[k], k
    assert out["collisions"] > 0


def test_run_eval_vec_knobs_and_sweep(tmp_path, actor_params):
    cfg = tiny(env={"max_steps": 10})
    for kw in ({"obs_noise": 0.2}, {"occlusion": 0.3}, {"greying": 1.0}):
        out = port_evaluate.run_eval_vec(cfg, actor_params, 4, "rrc",
                                         str(tmp_path), "m", device="cpu",
                                         **kw)
        assert 0 <= out["successes"] <= 4
    # the sweep path: one report a point, the clean point the static run
    reps = port_evaluate.run_eval_vec(cfg, actor_params, 4, "rrc",
                                      str(tmp_path), "m", sweep=[{}],
                                      device="cpu")
    clean = port_evaluate.run_eval_vec(cfg, actor_params, 4, "rrc",
                                       str(tmp_path), "m", device="cpu")
    assert isinstance(reps, list) and len(reps) == 1
    for k in ("successes", "collisions", "durations"):
        assert reps[0][k] == clean[k], k


def test_command_lines(tmp_path, capsys):
    import yaml

    cfg = tiny(env={"max_steps": 6}, train={"save": True})
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(yaml.safe_dump(cfg.to_dict()))
    common = ["--config", str(cfg_yaml), "--device", "cpu", "--n-envs", "2",
              "--chunk", "6"]
    ft.main([*common, "--rounds", "2", "--rounds-per-dispatch", "1",
             "--updates-per-round", "1", "--ring-capacity", "32", "--out",
             str(tmp_path / "fused")])
    assert "rounds: 2  env steps: 24" in capsys.readouterr().out
    vr.main([*common, "--env-steps", "12", "--updates-per-chunk", "1",
             "--out", str(tmp_path / "vec")])
    assert "env steps: 12" in capsys.readouterr().out
    port_evaluate.main(["--checkpoint", str(tmp_path / "fused"
                                            / "checkpoints"),
                        "--config", str(cfg_yaml), "--device", "cpu",
                        "--vec-eval", "--world", "randm4", "--episodes", "3",
                        "--out", str(tmp_path / "eval")])
    assert "success rate: " in capsys.readouterr().out


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.train_fused(tiny(), out_dir=str(tmp_path), rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vr.train_vec(tiny(), out_dir=str(tmp_path), total_env_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_evaluate.run_eval_vec(tiny(), {}, 2, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vk.make_consts("rrc", image_hw=HW)
