"""The port's deployable artifact (dgvit_tpu_torch/serve/export.py:
`export_actor`, `load_actor`, `main`) and the fleet's `env_units_baked`
on the CPU, mirroring the JAX package's tests/test_serve.py export cases.

The artifact is a `torch.export` program of the deterministic deployment
map traced on the CPU over the composed plain route. Held, fp32 on both
sides, at atol 1e-6: against the same map run eagerly on the port's plain
route and against the JAX package's actor (its XLA path) on the same
parameters, through one symbolic batch at b = 1, 3 and 8; with
env_units; pinned to one batch (another size is refused); through the
CLI. A platform other than one of cpu / cuda is refused.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core import checkpoint as jckpt
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.models.jax_io import params_from_jax
from dgvit_tpu_torch.models.policies import build_actor
from dgvit_tpu_torch.serve import FleetRunner, serve_fleet
from dgvit_tpu_torch.serve import export as port_export
from dgvit_tpu_torch.serve.export import export_actor, load_actor

HW = (32, 40)
SMALL = {"model": {"latent_size": 16, "dim_head": 16, "mlp_dim": 32,
                   "block": 2, "head": 2, "image_size": list(HW)}}
ATOL = 1e-6


def cfgs(**model):
    over = {"model": dict(SMALL["model"], **model)}
    return Config.from_dict(over), JaxConfig.from_dict(over)


@pytest.fixture(scope="module")
def small():
    cfg, jcfg = cfgs()
    params = jax_build_actor(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, *HW)), np.zeros((1, 2)))["params"]
    return cfg, jcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def artifacts(small):
    """The small actor exported on the CPU with a symbolic batch: policy
    units, and env units."""
    cfg, _, params = small
    return {units: export_actor(cfg, params, env_units=units,
                                platforms=["cpu"]) for units in (False, True)}


def inputs(b, seed=None):
    rng = np.random.default_rng(b if seed is None else seed)
    return (rng.uniform(0, 1, (b, *HW)).astype(np.float32),
            rng.normal(0, 0.3, (b, 2)).astype(np.float32))


def jax_actions(jcfg, params, obs, goal):
    out = jax.jit(jax_build_actor(jcfg).apply)({"params": params}, obs, goal)
    if jcfg.model.actor_type.startswith("Deterministic"):
        return np.asarray(out, np.float32)
    return np.tanh(np.asarray(out[0], np.float32))


def plain_actions(cfg, params, obs, goal):
    """The map run eagerly on the port's composed plain route."""
    policy = build_actor(cfg, attn_impl="xla")
    policy.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = policy(torch.from_numpy(obs), torch.from_numpy(goal))
    return (out if cfg.model.actor_type.startswith("Deterministic")
            else torch.tanh(out[0])).numpy()


def to_units(cfg, a):
    e = cfg.env
    a = a.clip(-e.max_action, e.max_action)
    return np.stack([(a[:, 0] + 1) * e.linear_cmd_scale,
                     a[:, 1] * e.angular_cmd_scale], axis=-1)


def test_export_roundtrip_symbolic_batch(small, artifacts, tmp_path):
    cfg, jcfg, params = small
    path = tmp_path / "actor.pt2"
    path.write_bytes(artifacts[False])
    act = load_actor(path.read_bytes())
    assert act.device == torch.device("cpu")
    for b in (1, 3, 8):
        obs, goal = inputs(b)
        got = act(obs, goal).numpy()
        assert got.shape == (b, 2)
        np.testing.assert_allclose(got, plain_actions(cfg, params, obs, goal),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, jax_actions(jcfg, params, obs, goal),
                                   rtol=0, atol=ATOL)


def test_export_holds_no_custom_kernel(artifacts):
    """The program is the composed plain route: none of the kernel
    wrappers, whatever the route rules would pick for these shapes."""
    act = load_actor(artifacts[False])
    graph = str(act.program.graph)
    for name in ("got_forward", "blocks_cls", "block_fwd", "cls_fwd",
                 "attention_fused", "fused_attention_section"):
        assert name not in graph, name


def test_export_env_units(small, artifacts):
    cfg, jcfg, params = small
    act = load_actor(artifacts[True])
    obs, _ = inputs(4, seed=0)
    goal = np.zeros((4, 2), np.float32)
    got = act(obs, goal).numpy()
    np.testing.assert_allclose(
        got, to_units(cfg, jax_actions(jcfg, params, obs, goal)), rtol=0,
        atol=ATOL)
    assert got[:, 0].min() >= 0.0


def test_export_fixed_batch(small):
    cfg, jcfg, params = small
    act = load_actor(export_actor(cfg, params, platforms=["cpu"], batch=4))
    obs, goal = inputs(4)
    np.testing.assert_allclose(act(obs, goal).numpy(),
                               jax_actions(jcfg, params, obs, goal),
                               rtol=0, atol=ATOL)
    with pytest.raises(Exception):
        act(*inputs(2))


@pytest.mark.parametrize("platforms,word", [
    (["cpu", "tpu"], "bound to the device"), (["cpu", "cuda"], "bound"),
    (["tpu"], "'tpu'"), ("tpu", "'tpu'"), (["metal"], "unknown platform")])
def test_export_refuses_other_platforms(small, platforms, word):
    cfg, _, params = small
    with pytest.raises(ValueError, match=word):
        export_actor(cfg, params, platforms=platforms)


def test_export_cuda_needs_a_card(small):
    cfg, _, params = small
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        export_actor(cfg, params)


def test_export_cli(small, tmp_path):
    """The CLI: an actor npz and a config in, the artifact out, a pinned
    batch of 2."""
    import yaml

    cfg, jcfg, params = small
    jckpt.save_params_npz(str(tmp_path), "served", params)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    out = tmp_path / "actor.pt2"
    port_export.main(["--actor", str(tmp_path / "served_actor.npz"),
                      "--out", str(out), "--config", str(path),
                      "--platforms", "cpu", "--batch", "2"])
    act = load_actor(out.read_bytes())
    obs, goal = inputs(2)
    np.testing.assert_allclose(act(obs, goal).numpy(),
                               jax_actions(jcfg, params, obs, goal),
                               rtol=0, atol=ATOL)
    with pytest.raises(Exception):
        act(*inputs(3))


def test_export_deterministic_actor():
    """A deterministic actor's own squashed action, not tanh'd again."""
    cfg, jcfg = cfgs(actor_type="DeterministicTransformer")
    params = jax_build_actor(jcfg).init(
        jax.random.PRNGKey(2), np.zeros((1, 128, 160)),
        np.zeros((1, 2)))["params"]
    cfg.model.image_size = [128, 160]
    act = load_actor(export_actor(cfg, params, platforms=["cpu"]))
    rng = np.random.default_rng(4)
    obs = rng.uniform(0, 1, (3, 128, 160)).astype(np.float32)
    goal = np.zeros((3, 2), np.float32)
    ref = np.asarray(jax_build_actor(jcfg).apply({"params": params}, obs,
                                                 goal), np.float32)
    np.testing.assert_allclose(act(obs, goal).numpy(), ref, rtol=0,
                               atol=ATOL)


class Commands:
    """An env of fixed frames that records the commands it is given."""

    def __init__(self, steps=4):
        self.steps, self.seen, self.collision = steps, [], 0

    def reset(self):
        from dgvit_tpu_torch.envs import ResetResult
        obs, goal = inputs(1, seed=9)
        return ResetResult(obs[0][..., None], 0.0, 0.0,
                           np.concatenate([goal[0], [0.0, 0.0]]))

    def step(self, a_in, t):
        from dgvit_tpu_torch.envs import StepResult
        self.seen.append(np.asarray(a_in, np.float32))
        obs, goal = inputs(1, seed=9 + t + 1)
        return StepResult(obs[0][..., None], 0.0, t + 1 == self.steps,
                          np.concatenate([goal[0], [0.0, 0.0]]), False)


def test_fleet_env_units_baked(small, artifacts):
    """A fleet served by the env-units artifact with env_units_baked sends
    the same commands as one served policy units and scaled by the
    runner (JAX serve/fleet.py:109)."""
    cfg, _, params = small
    cfg = copy.deepcopy(cfg)
    cfg.env.max_steps = 4
    policy, baked = (load_actor(artifacts[units]) for units in (False, True))
    envs = [Commands(), Commands()]
    FleetRunner(envs[:1], lambda o, g: policy(o[None], g[None])[0].numpy(),
                cfg).run(1)
    out = serve_fleet(cfg, envs[1:], lambda o, g: baked(o, g).numpy(),
                      env_units_baked=True)
    assert out["episodes"] == 1 and out["serving"]["requests"] == 4
    np.testing.assert_allclose(np.stack(envs[1].seen),
                               np.stack(envs[0].seen), rtol=0, atol=1e-6)


def test_console_scripts():
    """setup.py names the port's export and offline trainer beside the
    JAX package's entries, which stay as they were; each resolves."""
    import ast
    import importlib
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "setup.py")
                     .read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "setup")
    kw = next(k for k in call.keywords if k.arg == "entry_points")
    scripts = dict(e.split("=") for e in
                   ast.literal_eval(kw.value)["console_scripts"])
    assert scripts["dgvit-export"] == "dgvit_tpu.serve.export:main"
    assert scripts["dgvit-torch-export"] == \
        "dgvit_tpu_torch.serve.export:main"
    assert scripts["dgvit-torch-train-offline"] == \
        "dgvit_tpu_torch.train.train_offline:main"
    for name, target in scripts.items():
        if name.startswith("dgvit-torch-"):
            mod, fn = target.split(":")
            assert callable(getattr(importlib.import_module(mod), fn))
