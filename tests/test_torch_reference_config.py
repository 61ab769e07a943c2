"""The reference's own configuration on the port, on the CPU:
`config.load_reference_yaml` against the JAX package's translator, field
for field, and `train_rl.main(["--reference-config", ...])` end to end.

The yaml is written here with the keys the translators read
(dgvit_tpu/config.py:328-382), the reference's values where they shape
the run (critic_type CNN, VIS_SENSOR fish_image, P_ATTENTION_FIX), and a
small depth, batch and episode length so that the run stays short: the
translator sets no image size or MLP width, so the trunk keeps the
flagship's 128 x 160 frames and MLP 2048.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from dgvit_tpu.config import load_reference_yaml as jax_load_reference_yaml
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import load_reference_yaml
from dgvit_tpu_torch.models.policies import GoTPolicy, QNetwork
from dgvit_tpu_torch.train import train_rl

REFERENCE = {
    "SEED": 11, "DESC": 98, "LATENT_FEATURES_SIZE": 32,
    "BATCH_SIZE": 4, "LR_A": 3e-4, "LR_C": 3e-4, "LR_ALPHA": 1e-4,
    "GAMMA": 0.999, "TAU": 0.0005, "ACTOR_FREQ": 1, "BUFFER_SIZE": 64,
    "ALPHA": 1.0, "AUTO_TUNE": True, "VIS_SENSOR": "fish_image",
    "MAX_STEPS": 12, "MAX_EPISODES": 800, "L_SCALE": 0.25, "A_SCALE": 1.0,
    "FRAME_STACK": 4, "PLOT_INTERVAL": 10, "EVAL_THRESHOLD": 80,
    "EVAL_EPOCH": 5, "SAVE_INTERVAL": 50, "SAVE_THRESHOLD": 1.0,
    "REWARD_THRESHOLD": 90.0, "SAVE": True, "PRE_TRAIN": True,
    "IF_TEST": False, "PRE_BUFFER": True, "HUMAN_INTERVENTION": False,
    "P_ATTENTION_FIX": True, "C_ATTENTION_FIX": False, "ROBOT": "scout",
    "GoT-SAC": {"name": "gtrl", "actor_type": "GaussianTransformer",
                "critic_type": "CNN", "block": 1, "head": 2},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are small, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_yaml(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(REFERENCE))
    return path


def test_translation_matches_jax_field_for_field(reference_yaml):
    port = load_reference_yaml(str(reference_yaml))
    ref = jax_load_reference_yaml(str(reference_yaml))
    for section in ("model", "sac", "env", "train"):
        for name, value in vars(getattr(port, section)).items():
            assert value == getattr(getattr(ref, section), name), \
                f"{section}.{name}"
    assert port.model.critic_type == "CNN"
    assert port.env.vis_sensor == "fish_image"
    assert port.train.policy_attention_fix is True
    assert port.train.critic_attention_fix is False
    assert port.train.desc == "98" and port.train.seed == 11
    assert port.model.compute_dtype == "float32"


def test_translated_config_builds_the_reference_networks(reference_yaml):
    cfg = load_reference_yaml(str(reference_yaml))
    agent = SACAgent(cfg, device="cpu")
    state = agent.init_state()
    assert isinstance(state.actor, GoTPolicy)
    assert isinstance(state.critic, QNetwork)
    assert agent.dtype is None and agent.actor_fix
    assert not agent.critic_fix      # the fix reaches Transformer critics only
    held = {id(p) for g in state.actor_opt.param_groups for p in g["params"]}
    assert not any(id(p) in held for p in state.actor.trans.parameters())


def test_reference_config_trains_and_evaluates(reference_yaml, tmp_path,
                                               capsys):
    out = tmp_path / "run"
    train_rl.main(["--reference-config", str(reference_yaml), "--device",
                   "cpu", "--episodes", "1", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "critic_type: CNN" in printed and "actor_type: " \
        "GaussianTransformer" in printed
    summary = (out / "training_data.txt").read_text()
    assert "critic_type: CNN" in summary and "Id = 98" in summary
    rows = [json.loads(line) for line in
            (out / "train_gtrl_98.jsonl").read_text().splitlines()]
    assert rows and all(np.isfinite(r["qf1_loss"]) for r in rows
                        if "qf1_loss" in r)
    assert any("qf1_loss" in r for r in rows), "no update ran"

    from dgvit_tpu_torch.core import checkpoint as ckpt
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.train.evaluate import run_eval

    cfg = load_reference_yaml(str(reference_yaml))
    actor = ckpt.load_params_npz(
        str(next((out / "models").glob("*_actor.npz"))))
    env = KinematicNavEnv(seed=cfg.train.seed,
                          image_hw=tuple(cfg.model.image_size))
    report = run_eval(cfg, env, actor, max_episodes=2,
                      out_dir=str(tmp_path / "eval"), device="cpu")
    assert 0 <= report["successes"] <= 2
    assert 0.0 <= report["success_rate"] <= 1.0
