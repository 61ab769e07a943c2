"""The port's frozen-actor teacher (dgvit_tpu_torch/agents/teacher.py) and
its demo tool (dgvit_tpu_torch/tools/record_teacher_demos.py) against the
JAX package's, on the CPU at a tiny geometry (one block, 32x40 frames).

Mirrors tests/test_teacher.py:24,47. The teacher's fp32 actions agree
with JAX's `SACTeacher` on the same npz within 1e-5 (fp32 on both sides,
the sums in another order), single and batched; the teacher acts in the
config's compute dtype. The tool's flags are the JAX tool's with
--device for --platform (read from its source), and it runs end to end
with --keep-failures and without it.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.agents import SACTeacher as JaxTeacher
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core import checkpoint as jax_ckpt
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu_torch.agents import SACTeacher
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.tools import record_teacher_demos as rtd
from dgvit_tpu_torch.train.demo_record import record_episodes

ROOT = Path(__file__).resolve().parent.parent
JAX_TOOL = ROOT / "tools" / "record_teacher_demos.py"
HW = (32, 40)
ACT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_dict(dtype="float32"):
    return {"model": {"block": 1, "head": 2, "latent_size": 16,
                      "mlp_dim": 32, "image_size": HW,
                      "patch_size": (16, 20), "compute_dtype": dtype},
            "env": {"max_steps": 10}}


@pytest.fixture(scope="module")
def teacher_npz(tmp_path_factory):
    """A tiny actor's npz, JAX's init x3 (its actions then vary with the
    frames)."""
    d = tmp_path_factory.mktemp("teacher")
    actor = jax_build_actor(JaxConfig.from_dict(cfg_dict()))
    params = actor.init(jax.random.PRNGKey(0), np.zeros((1, *HW)),
                        np.zeros((1, 2)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, params)
    jax_ckpt.save_params_npz(str(d), "teach", params)
    return d, params


def frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, *HW), np.float32),
            rng.uniform(-1, 1, (n, 2)).astype(np.float32))


def test_teacher_loads_and_acts(teacher_npz):
    d, params = teacher_npz
    t = SACTeacher(Config.from_dict(cfg_dict()), "teach", str(d),
                   device="cpu")
    obs, goal = frames(3)
    a = t.choose_action(obs[0], goal[0])
    assert a.shape == (2,) and np.all(np.abs(a) <= 1.0)  # tanh'd mean
    ab = t.choose_action(obs, goal)
    assert ab.shape == (3, 2)
    np.testing.assert_allclose(ab[0], a, rtol=1e-5, atol=1e-6)
    # the exact deployment map: tanh(mean) of the live actor
    with torch.no_grad():
        mean, _ = t._act.policy(torch.from_numpy(obs[:1]),
                                torch.from_numpy(goal[:1]), inference=True)
    np.testing.assert_allclose(a, np.tanh(mean.numpy())[0], atol=1e-6)


@pytest.mark.parametrize("batch", [1, 5])
def test_teacher_actions_match_jax(teacher_npz, batch):
    d, _ = teacher_npz
    jt = JaxTeacher(JaxConfig.from_dict(cfg_dict()), "teach", str(d))
    t = SACTeacher(Config.from_dict(cfg_dict()), "teach", str(d),
                   device="cpu")
    obs, goal = frames(batch, seed=batch)
    goal4 = np.concatenate([goal, np.ones_like(goal)], axis=1)
    if batch == 1:
        obs, goal4 = obs[0], goal4[0]
    ours, theirs = t.choose_action(obs, goal4), jt.choose_action(obs, goal4)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ACT_TOL)


def test_teacher_acts_in_the_configs_dtype(teacher_npz):
    d, _ = teacher_npz
    dt = lambda t: t._act.policy.trans.compute_dtype
    assert dt(SACTeacher(Config.from_dict(cfg_dict()), "teach", str(d),
                         device="cpu")) == torch.float32
    assert dt(SACTeacher(Config.from_dict(cfg_dict("bfloat16")), "teach",
                         str(d), device="cpu")) == torch.bfloat16
    assert dt(SACTeacher(Config.from_dict(cfg_dict()), "teach", str(d),
                         dtype="bfloat16", device="cpu")) == torch.bfloat16
    assert Config().model.compute_dtype == "float32"


def test_teacher_records_demo_corpus(teacher_npz, tmp_path):
    d, _ = teacher_npz
    cfg = Config.from_dict(cfg_dict())
    teacher = SACTeacher(cfg, "teach", str(d), device="cpu")
    source, to_env = teacher.as_pilot()
    a = np.array([0.25, -0.5], np.float32)
    assert to_env(a) == [1.25 * cfg.env.linear_cmd_scale,
                         -0.5 * cfg.env.angular_cmd_scale]
    obs, goal = frames(1, seed=9)
    np.testing.assert_array_equal(
        source(obs[0][..., None], np.r_[goal[0], 1.0, 1.0], 0),
        np.clip(teacher.choose_action(obs[0], goal[0]), -1, 1))
    env = KinematicNavEnv(records=default_records(seed=3), image_hw=HW)
    paths = record_episodes(env, source, str(tmp_path / "demos"),
                            episodes=2, max_steps=10, action_to_env=to_env)
    assert paths
    z = np.load(paths[0])
    assert z["obs"].shape[1:] == HW and z["act"].shape[1:] == (2,)
    assert np.all(np.abs(z["act"]) <= cfg.env.max_action)  # policy units


def jax_tool_flags():
    tree = ast.parse(JAX_TOOL.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return {c.args[0].value for c in ast.walk(main)
            if isinstance(c, ast.Call)
            and getattr(c.func, "attr", "") == "add_argument"}


def tool_flags(monkeypatch):
    seen = []
    real = rtd.argparse.ArgumentParser.add_argument

    def spy(self, *names, **kw):
        seen.append(names[0])
        return real(self, *names, **kw)
    monkeypatch.setattr(rtd.argparse.ArgumentParser, "add_argument", spy)
    with pytest.raises(SystemExit):
        rtd.main(["--help"])
    return set(seen) - {"-h"}


def test_tool_flags_are_the_jax_tools(monkeypatch, capsys):
    assert tool_flags(monkeypatch) == (jax_tool_flags() - {"--platform"}
                                       | {"--device"})


def run_tool(d, out, *more):
    return rtd.main(["--actor", str(d / "teach_actor.npz"), "--world",
                     "rand2", "--episodes", "2", "--max-steps", "6",
                     "--out", str(out), "--device", "cpu", *more],
                    base=Config.from_dict(cfg_dict()))


def test_tool_keeps_failures_on_request(teacher_npz, tmp_path, capsys):
    d, _ = teacher_npz
    kept = run_tool(d, tmp_path / "all", "--keep-failures")
    assert sorted(Path(p).name for p in kept) == ["demo_rand2_0.npz",
                                                  "demo_rand2_1.npz"]
    assert all(Path(p).parent == tmp_path / "all" / "rand2" / "teacher"
               for p in kept)
    with np.load(kept[0]) as z:
        assert set(z.files) == {"obs", "act", "goal", "reward", "next_obs",
                                "next_goal", "done"}
        assert np.all(np.abs(z["act"]) <= 1.0)
    assert "teacher demos: kept 2 / dropped 0 (of 2 recorded over 2 " \
        "worlds)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        rtd.main(["--actor", str(d / "teach.npz"), "--device", "cpu"])
    assert "must be a <name>_actor.npz file" in capsys.readouterr().err


def test_tool_keeps_successes_only(teacher_npz, tmp_path, monkeypatch,
                                   capsys):
    """Without --keep-failures an episode survives only where the goal's
    reward was seen: one planted success kept, the failure dropped; an
    all-failure corpus exits non-zero."""
    d, _ = teacher_npz
    real = rtd.record_episodes

    def planted(*a, **k):
        paths = real(*a, **k)
        if k["start_index"] == 0:
            z = dict(np.load(paths[0]))
            z["reward"][-1] = 200.0
            np.savez_compressed(paths[0], **z)
        return paths
    monkeypatch.setattr(rtd, "record_episodes", planted)
    kept = run_tool(d, tmp_path / "some")
    assert [Path(p).name for p in kept] == ["demo_rand2_0.npz"]
    assert sorted(p.name for p in (tmp_path / "some" / "rand2" / "teacher")
                  .iterdir()) == ["demo_rand2_0.npz"]
    assert "kept 1 / dropped 1" in capsys.readouterr().out
    monkeypatch.setattr(rtd, "record_episodes", real)
    with pytest.raises(SystemExit, match="corpus is empty"):
        run_tool(d, tmp_path / "none")
