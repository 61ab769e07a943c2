"""The port's behaviour-cloning trainer (dgvit_tpu_torch/agents/bc.py) and
its command line (dgvit_tpu_torch/train/train_bc.py) against the JAX
package's, on the CPU at a tiny geometry (one block, two heads, 32x40
frames).

Mirrors tests/test_bc_checkpoint.py:29,36,47,106,
tests/test_round3_fixes.py:58 and tests/test_drivers.py:76, and holds:
  * a 3-epoch fit to JAX's `BCTrainer.fit` from the same initial
    parameters (JAX's init carried in through `init_params=`) on the same
    corpus: the per-epoch losses within 1e-5 and the best parameters
    within 5e-4 (half an Adam step at lr 1e-3: Adam moves a weight by
    about lr whatever its gradient's size, so a near-zero gradient whose
    sign the two float orders part on moves the weight apart by up to two
    steps; the corpus here reads 6.4e-5);
  * the clip to optax.clip_by_global_norm above and below the norm;
  * `il_policy`'s channels-mode forward to JAX's with the weights carried;
  * `train_bc.main` end to end, its files read by JAX's loader.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgvit_tpu.agents import bc as jbc
from dgvit_tpu.core import checkpoint as jax_ckpt
from dgvit_tpu_torch.agents import bc
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.models import GoTPolicy, params_from_jax
from dgvit_tpu_torch.models.jax_io import _flatten
from dgvit_tpu_torch.train import train_bc
from dgvit_tpu_torch.train.demo_record import record_episodes, scripted_pilot

HW = (32, 40)
TINY = dict(block=1, head=2, l_f_size=32, mlp_dim=64)
LOSS_TOL, PARAM_TOL = 1e-5, 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_bc(batch_size=8, seed=1):
    return bc.BCTrainer(model=bc.il_policy(**TINY), batch_size=batch_size,
                        seed=seed, device="cpu")


def tiny_2d(final_norm="rms"):
    return functools.partial(GoTPolicy, block=1, head=2, l_f_size=32,
                             mlp_dim=64, image_size=HW, patch_size=(16, 20),
                             final_norm=final_norm, emb_dropout=0.0)


def synthetic_demos(n=64, seed=0):
    """Frame stacks (N, 32, 40, 4) with a learnable goal -> action map."""
    rng = np.random.default_rng(seed)
    obs = rng.random((n, *HW, 4), np.float32)
    goal = rng.random((n, 4), np.float32)
    act = np.tanh(np.stack([goal[:, 0] - 0.5, goal[:, 1] - 0.5],
                           1)).astype(np.float32)
    return obs, goal, act


def test_split_80_20_is_jaxs():
    tr, va = bc.split_80_20(100, seed=0)
    assert len(tr) == 80 and len(va) == 20
    assert len(np.intersect1d(tr, va)) == 0
    assert sorted(np.concatenate([tr, va])) == list(range(100))
    for n, seed in ((100, 0), (37, 5), (1, 1)):
        for ours, theirs in zip(bc.split_80_20(n, seed),
                                jbc.split_80_20(n, seed)):
            np.testing.assert_array_equal(ours, theirs)


def test_bc_loss_decreases():
    obs, goal, act = synthetic_demos(48)
    best, hist = tiny_bc().fit(obs, goal, act, epochs=5)
    assert hist["train"][-1] < hist["train"][0]
    assert len(hist["val"]) == 5 and np.isfinite(min(hist["val"]))
    assert all(isinstance(v, np.ndarray) for v in best.values())


def test_bc_best_params_track_lowest_val():
    """The returned parameters score the lowest validation loss seen."""
    obs, goal, act = synthetic_demos(48, seed=3)
    tr = tiny_bc()
    best, hist = tr.fit(obs, goal, act, epochs=3)
    vo = np.transpose(obs, (0, 3, 1, 2))
    _, va = bc.split_80_20(len(obs), 1)
    n = (len(va) // 8) * 8
    state = tr.init_state(vo.shape[1:], 2, init_params=best)
    with torch.no_grad():
        losses = [tr._rmse(state.model, *(torch.from_numpy(
            np.ascontiguousarray(a[va[i:i + 8]])) for a in
            (vo, goal[:, :2], act))).item() for i in range(0, n, 8)]
    assert np.mean(losses) == pytest.approx(min(hist["val"]), abs=1e-6)


def test_fit_matches_jax_from_the_same_init():
    obs, goal, act = synthetic_demos()
    jt = jbc.BCTrainer(model=jbc.il_policy(**TINY), batch_size=8, seed=1)
    init = jt.init_state(obs_shape=(4, *HW), pstate_dim=2).params
    jbest, jhist = jt.fit(obs, goal, act, epochs=3)
    best, hist = tiny_bc().fit(obs, goal, act, epochs=3, init_params=init)
    for k in ("train", "val"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=0, atol=LOSS_TOL)
    jflat = _flatten(jax.tree_util.tree_map(np.asarray, jbest))
    assert set(best) == set(jflat)
    for k, v in jflat.items():
        assert best[k].shape == v.shape, k
        np.testing.assert_allclose(best[k], v, rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["below", "above"])
def test_clip_is_optax_clip_by_global_norm(scale):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((3, 5), (7,), (2, 2, 2))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    assert (norm < 10.0) == (scale < 1.0)
    want, _ = optax.clip_by_global_norm(10.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ours = [torch.from_numpy(g.copy()) for g in grads]
    bc.clip_by_global_norm_(ours, 10.0)
    for o, w in zip(ours, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_il_policy_channels_forward_matches_jax():
    """The Imitation_learning.py actor (channels patch embedding of the
    4-frame stack, Layer final norm) on the gradient route BC trains."""
    rng = np.random.default_rng(2)
    obs = rng.random((3, 4, *HW), np.float32)
    goal = rng.random((3, 2), np.float32)
    jmodel = jbc.il_policy(**TINY)
    params = jmodel.init(jax.random.PRNGKey(6), jnp.zeros((1, 4, *HW)),
                         jnp.zeros((1, 2)))["params"]
    jmean, jlog = jmodel.apply({"params": params}, jnp.asarray(obs),
                               jnp.asarray(goal))
    state = tiny_bc().init_state((4, *HW), 2, init_params=params)
    mean, log_std = state.model(torch.from_numpy(obs),
                                torch.from_numpy(goal), inference=False)
    assert state.model.trans.patch_embed.weight.shape[1] == 16 * 20 * 4
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(jlog),
                               rtol=1e-5, atol=1e-5)


def test_channels_come_from_the_data():
    """il_policy() on a 4-channel corpus builds a 1280-wide patch
    embedding; a 2d policy on (N, H, W) frames a 320-wide one; a policy
    given frames of the other kind raises by name."""
    tr = tiny_bc()
    assert tr.init_state((4, *HW), 2).model.trans.patch_embed.in_features \
        == 1280
    tr2 = bc.BCTrainer(model=tiny_2d(), device="cpu")
    assert tr2.init_state(HW, 2).model.trans.patch_embed.in_features == 320
    with pytest.raises(ValueError, match="'channels' policy"):
        tr.init_state(HW, 2)
    with pytest.raises(ValueError, match="'2d' policy"):
        tr2.init_state((4, *HW), 2)
    with pytest.raises(TypeError, match="constructor"):
        bc.BCTrainer(model=tiny_2d()(), device="cpu")


def test_bc_fit_small_val_split_stays_finite():
    """A val split smaller than batch_size stacks to one clamped batch."""
    tr = bc.BCTrainer(model=tiny_2d(), batch_size=64, seed=0, device="cpu")
    n = 40   # val split = 8 < batch_size
    obs = np.random.default_rng(0).random((n, *HW), np.float32)
    goal = np.random.default_rng(1).random((n, 2), np.float32)
    act = np.random.default_rng(2).random((n, 2), np.float32)
    best, hist = tr.fit(obs, goal, act, epochs=2, to_chw=False)
    assert np.isfinite(hist["val"]).all()
    assert all(isinstance(v, np.ndarray) for v in best.values())


def test_bc_tiny_dataset_val_guard():
    """n=1: int(0.8*1) == 0 leaves the train split empty; both splits
    fall back to the available row."""
    rng = np.random.default_rng(0)
    obs = rng.random((1, *HW), np.float32)
    goal = rng.random((1, 2), np.float32)
    act = rng.uniform(-1, 1, (1, 2)).astype(np.float32)
    tr = bc.BCTrainer(model=tiny_2d(), batch_size=2, seed=0, device="cpu")
    _, hist = tr.fit(obs, goal, act, epochs=2, to_chw=False)
    assert np.isfinite(hist["val"]).all()
    assert np.isfinite(hist["train"]).all()


def test_bc_dataset_loader_and_fit(tmp_path):
    """Demos the port records, loaded and fitted as (H, W) frames."""
    env = KinematicNavEnv(records=default_records(seed=4), image_hw=HW)
    record_episodes(env, scripted_pilot, str(tmp_path), episodes=2,
                    max_steps=20)
    obs, act, goal = train_bc.load_bc_dataset(
        str(tmp_path / "RRC" / "torch" / "*.npz"))
    assert obs.shape[0] == act.shape[0] == goal.shape[0]
    assert obs.shape[1:] == HW and goal.shape[1] == 4
    tr = bc.BCTrainer(model=tiny_2d("layer"), batch_size=4, seed=1,
                      device="cpu")
    _, hist = tr.fit(obs, goal, act, epochs=2, to_chw=False)
    assert np.isfinite(hist["train"][-1])
    with pytest.raises(FileNotFoundError):
        train_bc.load_bc_dataset(str(tmp_path / "none" / "*.npz"))


def test_train_bc_main_files_load_in_jax(tmp_path, capsys):
    obs, goal, act = synthetic_demos(20, seed=7)
    data = tmp_path / "demos"
    data.mkdir()
    for i, (lo, hi) in enumerate(((0, 12), (12, 20))):
        np.savez(data / f"demo_{i}.npz", obs=obs[lo:hi], act=act[lo:hi],
                 goal=goal[lo:hi])
    out = tmp_path / "out"
    train_bc.main(["--data-glob", str(data / "*.npz"), "--epochs", "2",
                   "--batch-size", "4", "--block", "1", "--head", "2",
                   "--out", str(out), "--name", "il", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "dataset: obs=(20, 32, 40, 4)" in printed
    assert printed.count("Epoch:") == 2
    curves = np.load(out / "il_loss_curves.npy", allow_pickle=True).item()
    assert set(curves) == {"train", "val"}
    assert all(len(v) == 2 and all(isinstance(x, float) for x in v)
               for v in curves.values())
    assert f"best val loss {min(curves['val']):.4f}" in printed
    # JAX's loader reads the actor with its own il_policy's template
    template = jbc.il_policy(1, 2, 32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, *HW)),
        jnp.zeros((1, 2)))["params"]
    loaded = jax_ckpt.load_params_npz(str(out / "il_actor.npz"), template)
    ours = params_from_jax(dict(np.load(out / "il_actor.npz")))
    for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, loaded)).items():
        np.testing.assert_array_equal(v.numpy(), ours[k].numpy())


def test_fit_starts_from_the_seeded_init():
    """Two trainers of one seed draw the same parameters; another seed
    draws others (the port's own init, a seeded torch.Generator)."""
    a = tiny_bc(seed=3).init_state((4, *HW), 2).model.state_dict()
    b = tiny_bc(seed=3).init_state((4, *HW), 2).model.state_dict()
    c = tiny_bc(seed=4).init_state((4, *HW), 2).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trans.pos_embedding"],
                           c["trans.pos_embedding"])
